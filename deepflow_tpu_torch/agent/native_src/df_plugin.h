/* deepflow_tpu_torch shared-object L7 plugin ABI (the same ABI as the
 * JAX package's copy).
 *
 * Reference contract: agent/src/plugin/shared_obj/so_plugin.h —
 * on_check_payload/on_parse_payload over a parse_ctx, loaded with dlopen
 * and resolved by fixed symbol names (plugin/shared_obj/mod.rs:31
 * load_plugin). This is a clean-room redesign of that contract, not a
 * copy: the ctx keeps the fields the host actually has at dispatch time,
 * the record mirrors deepflow_tpu_torch.agent.l7.L7Record (the columnar row
 * the host builds anyway), and the plugin declares its protocol id/name
 * once at load instead of repeating them per check.
 *
 * A plugin .so must export, with C linkage:
 *   uint8_t     df_plugin_proto(void);        // protocol id (nonzero)
 *   const char* df_plugin_name(void);         // short protocol name
 *   int  df_check_payload(const struct df_parse_ctx*);   // 1 = mine
 *   int  df_parse_payload(const struct df_parse_ctx*,
 *                         struct df_l7_record* out);     // DF_ACTION_*
 * and may export:
 *   void df_plugin_init(void);                // once, after dlopen
 */

#ifndef DEEPFLOW_TPU_DF_PLUGIN_H
#define DEEPFLOW_TPU_DF_PLUGIN_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define DF_DIRECTION_C2S 0
#define DF_DIRECTION_S2C 1

#define DF_MSG_REQUEST 0
#define DF_MSG_RESPONSE 1

#define DF_ACTION_ERROR 0     /* payload is not this protocol after all */
#define DF_ACTION_CONTINUE 1  /* mine, but nothing loggable in this slice */
#define DF_ACTION_OK 2        /* out record filled */

struct df_parse_ctx {
  uint8_t ip_type;        /* 4 or 6 */
  uint8_t ip_src[16];     /* v4 in first 4 bytes */
  uint8_t ip_dst[16];
  uint16_t port_src;
  uint16_t port_dst;
  uint8_t l4_protocol;    /* 6 tcp, 17 udp */
  uint8_t direction;      /* DF_DIRECTION_*; 0xFF = unknown */
  uint64_t time_ns;
  int32_t payload_size;
  const uint8_t* payload; /* borrowed: valid only during the call */
};

struct df_l7_record {
  uint8_t msg_type;       /* DF_MSG_* */
  int32_t status;         /* protocol status code, 0 = ok */
  int32_t req_len;
  int32_t resp_len;
  char endpoint[128];     /* NUL-terminated method/resource */
};

uint8_t df_plugin_proto(void);
const char* df_plugin_name(void);
void df_plugin_init(void);
int df_check_payload(const struct df_parse_ctx* ctx);
int df_parse_payload(const struct df_parse_ctx* ctx,
                     struct df_l7_record* out);

#ifdef __cplusplus
}
#endif

#endif /* DEEPFLOW_TPU_DF_PLUGIN_H */
