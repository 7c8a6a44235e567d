// Sample L7 plugin: memcached text protocol.
//
// Demonstrates the df_plugin.h ABI end-to-end with a protocol the
// built-in parser set does not cover. Requests are ASCII command lines
// ("get <key>", "set <key> <flags> <exp> <bytes>", "delete <key>", ...);
// responses are "VALUE ...", "END", "STORED", "NOT_FOUND", "ERROR", etc.
// (The binary protocol is out of scope for the sample.)
//
// Build: g++ -shared -fPIC -O2 -std=c++17 memcached_plugin.cc \
//            -o memcached_plugin.so

#include "df_plugin.h"

#include <cstdio>
#include <cstring>

namespace {

constexpr uint8_t kProto = 201;   // private-range protocol id

struct Tok {
  const char* p;
  int len;
};

// first whitespace-delimited token of the payload, trimmed to the line
Tok first_token(const struct df_parse_ctx* ctx) {
  const char* p = reinterpret_cast<const char*>(ctx->payload);
  int n = ctx->payload_size;
  int i = 0;
  while (i < n && p[i] != ' ' && p[i] != '\r' && p[i] != '\n') ++i;
  return {p, i};
}

bool tok_is(const Tok& t, const char* word) {
  int len = static_cast<int>(std::strlen(word));
  return t.len == len && std::memcmp(t.p, word, len) == 0;
}

const char* const kRequests[] = {"get", "gets", "set", "add", "replace",
                                 "append", "prepend", "cas", "delete",
                                 "incr", "decr", "touch", "stats",
                                 "flush_all", "version", "quit"};
const char* const kResponses[] = {"VALUE", "END", "STORED", "NOT_STORED",
                                  "EXISTS", "NOT_FOUND", "DELETED",
                                  "TOUCHED", "OK", "ERROR", "CLIENT_ERROR",
                                  "SERVER_ERROR", "STAT", "VERSION"};

int classify(const Tok& t) {
  for (const char* w : kRequests)
    if (tok_is(t, w)) return DF_MSG_REQUEST;
  for (const char* w : kResponses)
    if (tok_is(t, w)) return DF_MSG_RESPONSE;
  return -1;
}

}  // namespace

extern "C" {

uint8_t df_plugin_proto(void) { return kProto; }

const char* df_plugin_name(void) { return "Memcached"; }

void df_plugin_init(void) {}

int df_check_payload(const struct df_parse_ctx* ctx) {
  if (ctx->l4_protocol != 6 || ctx->payload_size < 3) return 0;
  // text lines end with \r\n; require one inside the slice
  if (!std::memchr(ctx->payload, '\n', ctx->payload_size)) return 0;
  return classify(first_token(ctx)) >= 0;
}

int df_parse_payload(const struct df_parse_ctx* ctx,
                     struct df_l7_record* out) {
  Tok t = first_token(ctx);
  int kind = classify(t);
  if (kind < 0) return DF_ACTION_ERROR;
  std::memset(out, 0, sizeof(*out));
  out->msg_type = static_cast<uint8_t>(kind);
  if (kind == DF_MSG_REQUEST) {
    out->req_len = ctx->payload_size;
    // endpoint = "<command> <key>" (first two tokens)
    const char* p = reinterpret_cast<const char*>(ctx->payload);
    int n = ctx->payload_size;
    int i = t.len;
    while (i < n && p[i] == ' ') ++i;
    int j = i;
    while (j < n && p[j] != ' ' && p[j] != '\r' && p[j] != '\n') ++j;
    int cmd = t.len < 120 ? t.len : 120;
    std::memcpy(out->endpoint, t.p, cmd);
    if (j > i) {
      out->endpoint[cmd] = ' ';
      int key = j - i;
      if (key > 126 - cmd) key = 126 - cmd;
      std::memcpy(out->endpoint + cmd + 1, p + i, key);
    }
  } else {
    out->resp_len = ctx->payload_size;
    if (tok_is(t, "ERROR") || tok_is(t, "CLIENT_ERROR") ||
        tok_is(t, "SERVER_ERROR") || tok_is(t, "NOT_FOUND") ||
        tok_is(t, "NOT_STORED"))
      out->status = 1;
  }
  return DF_ACTION_OK;
}

}  // extern "C"
