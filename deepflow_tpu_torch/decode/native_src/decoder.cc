// Native columnar decoder: firehose payload -> L4_SCHEMA column arrays.
//
// The hot decode loop of the whole framework (reference: the reference
// keeps this path allocation-free in Go via simple_codec.go + gogoproto;
// here a direct protobuf wire-format walk writes straight into
// caller-provided numpy buffers, no intermediate message objects).
//
// Input layout: repeated | u32 LE record_len | record bytes | (see
// wire/codec.py pack_pb_records). Records are dftpu.flow_log.TaggedFlow
// messages (wire/protos/flow_log.proto — field numbers mirror the
// reference message/flow_log.proto so agent streams decode unchanged).
//
// Output: a uint32 buffer of shape [N_COLS32, capacity] plus a uint64
// buffer of shape [N_COLS64, capacity], row-major per column
// (out[col * capacity + row]). Column order must match batch/schema.py
// L4_SCHEMA: the u32/i32 columns first (int32 stored as its
// two's-complement uint32 image, exactly like the Python decoder), then
// the u64 tail block (mac_src, mac_dst, flow_id, start/end_time_us).
//
// Performance: the walk stays a naive tag-dispatch loop — hand-"optimized"
// variants (unrolled varint fast paths, single-byte tag dispatch) measured
// SLOWER under -O3 -march=native -funroll-loops; keep the loops simple and
// let the compiler schedule them. df_decode_l4_mt fans out over a
// persistent worker pool (DecodePool) for hosts with more than one core.
//
// This file is the port's own copy of the JAX package's decoder, with the
// same C ABI (df_decode_l4, df_decode_l4_mt, df_n_l4_cols,
// df_n_l4_cols64); deepflow_tpu_torch/decode/native.py builds it at first
// use into build/deepflow_tpu_torch/libnative_decoder.so:
//   g++ -O3 -march=native -funroll-loops -shared -fPIC -std=c++17 \
//       decoder.cc -o libnative_decoder.so -lpthread

#include <cstdint>
#include <cstring>
#include <cstddef>
#include <pthread.h>
#include <condition_variable>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// Persistent decode worker pool. A per-call std::thread spawn costs
// ~20-60us/thread — negligible against one 65k-record payload but real
// when the receiver drains many small frames per second on a multi-core
// host. Workers park on a condition variable between calls; worker id 0
// is always the calling thread, so a 1-core host (or n_threads=1) never
// touches the pool at all. run() is serialized: the decoder writes into
// caller-provided buffers, so concurrent decodes would race anyway.
class DecodePool {
 public:
  static DecodePool& instance() {
    static DecodePool p;
    return p;
  }

  // fork safety: a forked child inherits workers_ handles but none of
  // the threads — without this, its first MT decode would wait on
  // done_ forever. prepare/parent/child run the classic atfork
  // protocol: quiesce the pool across the fork (call_m_ guarantees no
  // run() in flight, m_ that no worker is mid-wakeup), then the child
  // abandons the stale handles and resets to the unspawned state.
  void atfork_prepare() { call_m_.lock(); m_.lock(); }
  void atfork_parent() { m_.unlock(); call_m_.unlock(); }
  void atfork_child() {
    for (auto& t : workers_) t.detach();   // threads do not exist here
    workers_.clear();
    job_ = nullptr;
    epoch_ = 0;
    want_ = 0;
    pending_ = 0;
    stop_ = false;
    m_.unlock();
    call_m_.unlock();
  }

  void run(int n, const std::function<void(int)>& fn) {
    if (n <= 1) { fn(0); return; }
    std::lock_guard<std::mutex> call(call_m_);
    ensure(n - 1);
    {
      std::lock_guard<std::mutex> lk(m_);
      job_ = &fn;
      want_ = n - 1;
      pending_ = n - 1;
      ++epoch_;
    }
    cv_.notify_all();
    fn(0);
    std::unique_lock<std::mutex> lk(m_);
    done_.wait(lk, [&] { return pending_ == 0; });
    job_ = nullptr;
  }

  ~DecodePool() {
    {
      std::lock_guard<std::mutex> lk(m_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

 private:
  DecodePool() {
    pthread_atfork(
        [] { instance().atfork_prepare(); },
        [] { instance().atfork_parent(); },
        [] { instance().atfork_child(); });
  }

  void ensure(int n) {
    std::lock_guard<std::mutex> lk(m_);
    while (static_cast<int>(workers_.size()) < n) {
      int id = static_cast<int>(workers_.size()) + 1;
      workers_.emplace_back([this, id] { loop(id); });
    }
  }

  void loop(int id) {
    uint64_t seen = 0;
    std::unique_lock<std::mutex> lk(m_);
    for (;;) {
      cv_.wait(lk, [&] {
        return stop_ || (epoch_ != seen && id <= want_);
      });
      if (stop_) return;
      seen = epoch_;
      const std::function<void(int)>* job = job_;
      lk.unlock();
      (*job)(id);
      lk.lock();
      if (--pending_ == 0) done_.notify_all();
    }
  }

  std::vector<std::thread> workers_;
  std::mutex m_, call_m_;
  std::condition_variable cv_, done_;
  const std::function<void(int)>* job_ = nullptr;
  uint64_t epoch_ = 0;
  int want_ = 0;
  int pending_ = 0;
  bool stop_ = false;
};

// L4_SCHEMA u32 column indices (batch/schema.py order)
enum {
  // core
  COL_IP_SRC = 0, COL_IP_DST, COL_PORT_SRC, COL_PORT_DST, COL_PROTO,
  COL_VTAP_ID, COL_TAP_SIDE, COL_L3_EPC_ID, COL_BYTE_TX, COL_BYTE_RX,
  COL_PACKET_TX, COL_PACKET_RX, COL_RTT, COL_RETRANS, COL_CLOSE_TYPE,
  COL_TIMESTAMP, COL_DURATION_US,
  // datalink
  COL_ETH_TYPE, COL_VLAN,
  // network / tunnel
  COL_IS_IPV6, COL_TUNNEL_TIER, COL_TUNNEL_TYPE, COL_TUNNEL_TX_ID,
  COL_TUNNEL_RX_ID, COL_TUNNEL_TX_IP_0, COL_TUNNEL_TX_IP_1,
  COL_TUNNEL_RX_IP_0, COL_TUNNEL_RX_IP_1,
  // transport
  COL_TCP_FLAGS_BIT_0, COL_TCP_FLAGS_BIT_1, COL_SYN_SEQ, COL_SYNACK_SEQ,
  COL_LAST_KEEPALIVE_SEQ, COL_LAST_KEEPALIVE_ACK,
  // application
  COL_L7_PROTOCOL,
  // internet (geo enrichment; zero at decode)
  COL_PROVINCE_0, COL_PROVINCE_1,
  // flow info
  COL_L3_EPC_ID_1, COL_SIGNAL_SOURCE, COL_TAP_TYPE, COL_TAP_PORT,
  COL_TAP_PORT_TYPE, COL_IS_NEW_FLOW, COL_IS_ACTIVE_SERVICE,
  COL_L2_END_0, COL_L2_END_1, COL_L3_END_0, COL_L3_END_1,
  COL_DIRECTION_SCORE, COL_GPROCESS_ID_0, COL_GPROCESS_ID_1,
  COL_NAT_REAL_IP_0, COL_NAT_REAL_IP_1, COL_NAT_REAL_PORT_0,
  COL_NAT_REAL_PORT_1, COL_NAT_SOURCE, COL_STATUS, COL_ACL_GIDS,
  // metrics
  COL_L3_BYTE_TX, COL_L3_BYTE_RX, COL_L4_BYTE_TX, COL_L4_BYTE_RX,
  COL_TOTAL_BYTE_TX, COL_TOTAL_BYTE_RX, COL_TOTAL_PACKET_TX,
  COL_TOTAL_PACKET_RX, COL_L7_REQUEST, COL_L7_RESPONSE,
  COL_L7_PARSE_FAILED, COL_L7_CLIENT_ERROR, COL_L7_SERVER_ERROR,
  COL_L7_SERVER_TIMEOUT, COL_RTT_CLIENT, COL_RTT_SERVER, COL_TLS_RTT,
  COL_SRT_SUM, COL_SRT_COUNT, COL_SRT_MAX,
  COL_ART_SUM, COL_ART_COUNT, COL_ART_MAX,
  COL_RRT_SUM, COL_RRT_COUNT, COL_RRT_MAX,
  COL_CIT_SUM, COL_CIT_COUNT, COL_CIT_MAX,
  COL_RETRANS_TX, COL_RETRANS_RX, COL_ZERO_WIN_TX, COL_ZERO_WIN_RX,
  COL_SYN_COUNT, COL_SYNACK_COUNT,
  COL_RETRANS_SYN, COL_RETRANS_SYNACK, COL_L7_ERROR,
  N_COLS32
};

// u64 tail block indices
enum {
  COL64_MAC_SRC = 0, COL64_MAC_DST, COL64_FLOW_ID, COL64_START_TIME_US,
  COL64_END_TIME_US, COL64_TUNNEL_TX_MAC, COL64_TUNNEL_RX_MAC,
  COL64_ID, N_COLS64
};

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
};

inline bool read_varint(Cursor& c, uint64_t* out) {
  // (a single-byte fast path was re-measured against this and still
  // loses — the loop's first iteration already predicts perfectly)
  uint64_t v = 0;
  int shift = 0;
  while (c.p < c.end && shift < 64) {
    uint8_t b = *c.p++;
    v |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) { *out = v; return true; }
    shift += 7;
  }
  return false;
}

// skip one field of the given wire type; returns false on malformed input
inline bool skip_field(Cursor& c, uint32_t wire_type) {
  uint64_t tmp;
  switch (wire_type) {
    case 0: return read_varint(c, &tmp);
    case 1: if (c.end - c.p < 8) return false; c.p += 8; return true;
    case 2:
      if (!read_varint(c, &tmp) ||
          static_cast<uint64_t>(c.end - c.p) < tmp) return false;
      c.p += tmp;
      return true;
    case 5: if (c.end - c.p < 4) return false; c.p += 4; return true;
    default: return false;
  }
}

// read tag; 0 = end of message / error
inline uint32_t next_tag(Cursor& c, uint32_t* wire_type) {
  if (c.p >= c.end) return 0;
  uint64_t key;
  if (!read_varint(c, &key)) return 0;
  *wire_type = static_cast<uint32_t>(key & 7);
  return static_cast<uint32_t>(key >> 3);
}

// open a length-delimited submessage as its own cursor
inline bool open_sub(Cursor& c, Cursor* sub) {
  uint64_t len;
  if (!read_varint(c, &len) ||
      static_cast<uint64_t>(c.end - c.p) < len) return false;
  sub->p = c.p;
  sub->end = c.p + len;
  c.p += len;
  return true;
}

// length-delimited IPv6 bytes field -> the system-wide u32 fold:
// FNV-1a confined to class E (dict_store.fold_ipv6 / packet.py
// _fold16_rows), so every path that keys on a folded v6 address —
// capture, this decoder, enrichment — produces the SAME u32 and never
// aliases a real v4 range. Only the two ip fields use this; string
// hashes stay full-range FNV.
inline bool read_bytes_fnv(Cursor& c, uint32_t* out, bool* nonempty) {
  uint64_t len;
  if (!read_varint(c, &len) ||
      static_cast<uint64_t>(c.end - c.p) < len) return false;
  uint32_t h = 0x811C9DC5u;
  for (uint64_t i = 0; i < len; ++i)
    h = (h ^ c.p[i]) * 0x01000193u;
  c.p += len;
  *out = h | 0xF0000000u;
  *nonempty = len > 0;
  return true;
}

struct Row {
  uint32_t v[N_COLS32];
  uint64_t v64[N_COLS64];
};

bool parse_flow_key(Cursor c, Row* r) {
  uint32_t wt;
  for (uint32_t tag; (tag = next_tag(c, &wt)) != 0; ) {
    uint64_t v;
    uint32_t h;
    bool nonempty;
    switch (tag) {
      case 1:  if (!read_varint(c, &v)) return false;
               r->v[COL_VTAP_ID] = static_cast<uint32_t>(v); break;
      case 2:  if (!read_varint(c, &v)) return false;
               r->v[COL_TAP_TYPE] = static_cast<uint32_t>(v); break;
      case 3:  if (!read_varint(c, &v)) return false;   // tap_port u64
               r->v[COL_TAP_PORT] = static_cast<uint32_t>(v);
               r->v[COL_TAP_PORT_TYPE] =
                   static_cast<uint32_t>((v >> 32) & 0xFF);
               break;
      case 4:  if (!read_varint(c, &v)) return false;
               r->v64[COL64_MAC_SRC] = v; break;
      case 5:  if (!read_varint(c, &v)) return false;
               r->v64[COL64_MAC_DST] = v; break;
      case 6:  if (!read_varint(c, &v)) return false;
               r->v[COL_IP_SRC] = static_cast<uint32_t>(v); break;
      case 7:  if (!read_varint(c, &v)) return false;
               r->v[COL_IP_DST] = static_cast<uint32_t>(v); break;
      case 8:  if (wt != 2 || !read_bytes_fnv(c, &h, &nonempty))
                 return false;
               if (nonempty) { r->v[COL_IP_SRC] = h;
                               r->v[COL_IS_IPV6] = 1; }
               break;
      case 9:  if (wt != 2 || !read_bytes_fnv(c, &h, &nonempty))
                 return false;
               if (nonempty) { r->v[COL_IP_DST] = h;
                               r->v[COL_IS_IPV6] = 1; }
               break;
      case 10: if (!read_varint(c, &v)) return false;
               r->v[COL_PORT_SRC] = static_cast<uint32_t>(v); break;
      case 11: if (!read_varint(c, &v)) return false;
               r->v[COL_PORT_DST] = static_cast<uint32_t>(v); break;
      case 12: if (!read_varint(c, &v)) return false;
               r->v[COL_PROTO] = static_cast<uint32_t>(v); break;
      default: if (!skip_field(c, wt)) return false;
    }
  }
  return true;
}

// per-side column targets for FlowMetricsPeer
struct PeerCols {
  int byte_col, pkt_col, epc_col, l3b_col, l4b_col, totb_col, totp_col,
      flags_col, l2end_col, l3end_col, realip_col, realport_col, gpid_col;
};

bool parse_peer(Cursor c, Row* r, const PeerCols& pc) {
  uint32_t wt;
  for (uint32_t tag; (tag = next_tag(c, &wt)) != 0; ) {
    uint64_t v;
    switch (tag) {
      case 1:  if (!read_varint(c, &v)) return false;
               r->v[pc.byte_col] = static_cast<uint32_t>(v); break;
      case 2:  if (!read_varint(c, &v)) return false;
               r->v[pc.l3b_col] = static_cast<uint32_t>(v); break;
      case 3:  if (!read_varint(c, &v)) return false;
               r->v[pc.l4b_col] = static_cast<uint32_t>(v); break;
      case 4:  if (!read_varint(c, &v)) return false;
               r->v[pc.pkt_col] = static_cast<uint32_t>(v); break;
      case 5:  if (!read_varint(c, &v)) return false;
               r->v[pc.totb_col] = static_cast<uint32_t>(v); break;
      case 6:  if (!read_varint(c, &v)) return false;
               r->v[pc.totp_col] = static_cast<uint32_t>(v); break;
      case 9:  if (!read_varint(c, &v)) return false;
               r->v[pc.flags_col] = static_cast<uint32_t>(v); break;
      case 10: if (!read_varint(c, &v)) return false;   // int32 l3_epc_id
               r->v[pc.epc_col] = static_cast<uint32_t>(v); break;
      case 11: if (!read_varint(c, &v)) return false;
               r->v[pc.l2end_col] = static_cast<uint32_t>(v); break;
      case 12: if (!read_varint(c, &v)) return false;
               r->v[pc.l3end_col] = static_cast<uint32_t>(v); break;
      case 20: if (!read_varint(c, &v)) return false;
               r->v[pc.realip_col] = static_cast<uint32_t>(v); break;
      case 21: if (!read_varint(c, &v)) return false;
               r->v[pc.realport_col] = static_cast<uint32_t>(v); break;
      case 22: if (!read_varint(c, &v)) return false;
               r->v[pc.gpid_col] = static_cast<uint32_t>(v); break;
      default: if (!skip_field(c, wt)) return false;
    }
  }
  return true;
}

const PeerCols kPeerSrc = {
  COL_BYTE_TX, COL_PACKET_TX, COL_L3_EPC_ID, COL_L3_BYTE_TX, COL_L4_BYTE_TX,
  COL_TOTAL_BYTE_TX, COL_TOTAL_PACKET_TX, COL_TCP_FLAGS_BIT_0,
  COL_L2_END_0, COL_L3_END_0, COL_NAT_REAL_IP_0, COL_NAT_REAL_PORT_0,
  COL_GPROCESS_ID_0
};
const PeerCols kPeerDst = {
  COL_BYTE_RX, COL_PACKET_RX, COL_L3_EPC_ID_1, COL_L3_BYTE_RX,
  COL_L4_BYTE_RX, COL_TOTAL_BYTE_RX, COL_TOTAL_PACKET_RX,
  COL_TCP_FLAGS_BIT_1, COL_L2_END_1, COL_L3_END_1, COL_NAT_REAL_IP_1,
  COL_NAT_REAL_PORT_1, COL_GPROCESS_ID_1
};

bool parse_tunnel(Cursor c, Row* r) {
  uint32_t wt;
  for (uint32_t tag; (tag = next_tag(c, &wt)) != 0; ) {
    uint64_t v;
    switch (tag) {
      case 1:  if (!read_varint(c, &v)) return false;
               r->v[COL_TUNNEL_TX_IP_0] = static_cast<uint32_t>(v); break;
      case 2:  if (!read_varint(c, &v)) return false;
               r->v[COL_TUNNEL_TX_IP_1] = static_cast<uint32_t>(v); break;
      case 3:  if (!read_varint(c, &v)) return false;
               r->v[COL_TUNNEL_RX_IP_0] = static_cast<uint32_t>(v); break;
      case 4:  if (!read_varint(c, &v)) return false;
               r->v[COL_TUNNEL_RX_IP_1] = static_cast<uint32_t>(v); break;
      case 5:  if (!read_varint(c, &v)) return false;   // tx_mac0 (hi)
               r->v64[COL64_TUNNEL_TX_MAC] =
                   (r->v64[COL64_TUNNEL_TX_MAC] & 0xFFFFFFFFULL)
                   | (v << 32); break;
      case 6:  if (!read_varint(c, &v)) return false;   // tx_mac1 (lo)
               r->v64[COL64_TUNNEL_TX_MAC] =
                   (r->v64[COL64_TUNNEL_TX_MAC]
                    & 0xFFFFFFFF00000000ULL) | (v & 0xFFFFFFFFULL);
               break;
      case 7:  if (!read_varint(c, &v)) return false;   // rx_mac0
               r->v64[COL64_TUNNEL_RX_MAC] =
                   (r->v64[COL64_TUNNEL_RX_MAC] & 0xFFFFFFFFULL)
                   | (v << 32); break;
      case 8:  if (!read_varint(c, &v)) return false;   // rx_mac1
               r->v64[COL64_TUNNEL_RX_MAC] =
                   (r->v64[COL64_TUNNEL_RX_MAC]
                    & 0xFFFFFFFF00000000ULL) | (v & 0xFFFFFFFFULL);
               break;
      case 9:  if (!read_varint(c, &v)) return false;
               r->v[COL_TUNNEL_TX_ID] = static_cast<uint32_t>(v); break;
      case 10: if (!read_varint(c, &v)) return false;
               r->v[COL_TUNNEL_RX_ID] = static_cast<uint32_t>(v); break;
      case 11: if (!read_varint(c, &v)) return false;
               r->v[COL_TUNNEL_TYPE] = static_cast<uint32_t>(v); break;
      case 12: if (!read_varint(c, &v)) return false;
               r->v[COL_TUNNEL_TIER] = static_cast<uint32_t>(v); break;
      default: if (!skip_field(c, wt)) return false;
    }
  }
  return true;
}

bool parse_tcp_counts_peer(Cursor c, Row* r, int retrans_col, int zwin_col) {
  uint32_t wt;
  for (uint32_t tag; (tag = next_tag(c, &wt)) != 0; ) {
    uint64_t v;
    switch (tag) {
      case 1: if (!read_varint(c, &v)) return false;
              r->v[retrans_col] = static_cast<uint32_t>(v); break;
      case 2: if (!read_varint(c, &v)) return false;
              r->v[zwin_col] = static_cast<uint32_t>(v); break;
      default: if (!skip_field(c, wt)) return false;
    }
  }
  return true;
}

bool parse_tcp_perf(Cursor c, Row* r) {
  uint32_t wt;
  for (uint32_t tag; (tag = next_tag(c, &wt)) != 0; ) {
    uint64_t v;
    Cursor sub;
    switch (tag) {
      case 1:  if (!read_varint(c, &v)) return false;
               r->v[COL_RTT_CLIENT] = static_cast<uint32_t>(v); break;
      case 2:  if (!read_varint(c, &v)) return false;
               r->v[COL_RTT_SERVER] = static_cast<uint32_t>(v); break;
      case 3:  if (!read_varint(c, &v)) return false;
               r->v[COL_SRT_MAX] = static_cast<uint32_t>(v); break;
      case 4:  if (!read_varint(c, &v)) return false;
               r->v[COL_ART_MAX] = static_cast<uint32_t>(v); break;
      case 5:  if (!read_varint(c, &v)) return false;   // rtt
               r->v[COL_RTT] = static_cast<uint32_t>(v); break;
      case 8:  if (!read_varint(c, &v)) return false;
               r->v[COL_SRT_SUM] = static_cast<uint32_t>(v); break;
      case 9:  if (!read_varint(c, &v)) return false;
               r->v[COL_ART_SUM] = static_cast<uint32_t>(v); break;
      case 12: if (!read_varint(c, &v)) return false;
               r->v[COL_SRT_COUNT] = static_cast<uint32_t>(v); break;
      case 13: if (!read_varint(c, &v)) return false;
               r->v[COL_ART_COUNT] = static_cast<uint32_t>(v); break;
      case 14: if (wt != 2 || !open_sub(c, &sub) ||
                   !parse_tcp_counts_peer(sub, r, COL_RETRANS_TX,
                                          COL_ZERO_WIN_TX)) return false;
               break;
      case 15: if (wt != 2 || !open_sub(c, &sub) ||
                   !parse_tcp_counts_peer(sub, r, COL_RETRANS_RX,
                                          COL_ZERO_WIN_RX)) return false;
               break;
      case 16: if (!read_varint(c, &v)) return false;   // total_retrans
               r->v[COL_RETRANS] = static_cast<uint32_t>(v); break;
      case 17: if (!read_varint(c, &v)) return false;
               r->v[COL_SYN_COUNT] = static_cast<uint32_t>(v); break;
      case 18: if (!read_varint(c, &v)) return false;
               r->v[COL_SYNACK_COUNT] = static_cast<uint32_t>(v); break;
      case 19: if (!read_varint(c, &v)) return false;
               r->v[COL_CIT_MAX] = static_cast<uint32_t>(v); break;
      case 20: if (!read_varint(c, &v)) return false;
               r->v[COL_CIT_SUM] = static_cast<uint32_t>(v); break;
      case 21: if (!read_varint(c, &v)) return false;
               r->v[COL_CIT_COUNT] = static_cast<uint32_t>(v); break;
      default: if (!skip_field(c, wt)) return false;
    }
  }
  return true;
}

bool parse_l7_perf(Cursor c, Row* r) {
  uint32_t wt;
  for (uint32_t tag; (tag = next_tag(c, &wt)) != 0; ) {
    uint64_t v;
    switch (tag) {
      case 1: if (!read_varint(c, &v)) return false;
              r->v[COL_L7_REQUEST] = static_cast<uint32_t>(v); break;
      case 2: if (!read_varint(c, &v)) return false;
              r->v[COL_L7_RESPONSE] = static_cast<uint32_t>(v); break;
      case 3: if (!read_varint(c, &v)) return false;
              r->v[COL_L7_CLIENT_ERROR] = static_cast<uint32_t>(v); break;
      case 4: if (!read_varint(c, &v)) return false;
              r->v[COL_L7_SERVER_ERROR] = static_cast<uint32_t>(v); break;
      case 5: if (!read_varint(c, &v)) return false;
              r->v[COL_L7_SERVER_TIMEOUT] = static_cast<uint32_t>(v); break;
      case 6: if (!read_varint(c, &v)) return false;
              r->v[COL_RRT_COUNT] = static_cast<uint32_t>(v); break;
      case 7: if (!read_varint(c, &v)) return false;   // rrt_sum u64
              r->v[COL_RRT_SUM] = static_cast<uint32_t>(v); break;
      case 8: if (!read_varint(c, &v)) return false;
              r->v[COL_RRT_MAX] = static_cast<uint32_t>(v); break;
      case 9: if (!read_varint(c, &v)) return false;
              r->v[COL_TLS_RTT] = static_cast<uint32_t>(v); break;
      default: if (!skip_field(c, wt)) return false;
    }
  }
  return true;
}

bool parse_perf_stats(Cursor c, Row* r) {
  uint32_t wt;
  for (uint32_t tag; (tag = next_tag(c, &wt)) != 0; ) {
    uint64_t v;
    Cursor sub;
    switch (tag) {
      case 1:                                           // tcp
        if (wt != 2 || !open_sub(c, &sub) || !parse_tcp_perf(sub, r))
          return false;
        break;
      case 2:                                           // l7
        if (wt != 2 || !open_sub(c, &sub) || !parse_l7_perf(sub, r))
          return false;
        break;
      case 4:                                           // l7_protocol
        if (!read_varint(c, &v)) return false;
        r->v[COL_L7_PROTOCOL] = static_cast<uint32_t>(v);
        break;
      case 5:                                           // l7_failed_count
        if (!read_varint(c, &v)) return false;
        r->v[COL_L7_PARSE_FAILED] = static_cast<uint32_t>(v);
        break;
      default:
        if (!skip_field(c, wt)) return false;
    }
  }
  return true;
}

bool parse_flow(Cursor c, Row* r) {
  uint32_t wt;
  for (uint32_t tag; (tag = next_tag(c, &wt)) != 0; ) {
    uint64_t v;
    Cursor sub;
    switch (tag) {
      case 1:                                            // flow_key
        if (!open_sub(c, &sub) || !parse_flow_key(sub, r)) return false;
        break;
      case 2:                                            // peer_src
        if (!open_sub(c, &sub) || !parse_peer(sub, r, kPeerSrc))
          return false;
        break;
      case 3:                                            // peer_dst
        if (!open_sub(c, &sub) || !parse_peer(sub, r, kPeerDst))
          return false;
        break;
      case 4:                                            // tunnel
        if (!open_sub(c, &sub) || !parse_tunnel(sub, r)) return false;
        break;
      case 5:                                            // flow_id
        if (!read_varint(c, &v)) return false;
        r->v64[COL64_FLOW_ID] = v;
        break;
      case 6:                                            // start_time ns
        if (!read_varint(c, &v)) return false;
        r->v[COL_TIMESTAMP] = static_cast<uint32_t>(v / 1000000000ULL);
        r->v64[COL64_START_TIME_US] = v / 1000ULL;
        break;
      case 7:                                            // end_time ns
        if (!read_varint(c, &v)) return false;
        r->v64[COL64_END_TIME_US] = v / 1000ULL;
        break;
      case 8: {                                          // duration ns
        if (!read_varint(c, &v)) return false;
        uint64_t us = v / 1000ULL;
        r->v[COL_DURATION_US] =
            us > 0xFFFFFFFFULL ? 0xFFFFFFFFu
                               : static_cast<uint32_t>(us);
        break;
      }
      case 10:                                           // vlan
        if (!read_varint(c, &v)) return false;
        r->v[COL_VLAN] = static_cast<uint32_t>(v);
        break;
      case 11:                                           // eth_type
        if (!read_varint(c, &v)) return false;
        r->v[COL_ETH_TYPE] = static_cast<uint32_t>(v);
        break;
      case 13:                                           // perf_stats
        if (!open_sub(c, &sub) || !parse_perf_stats(sub, r)) return false;
        break;
      case 14:                                           // close_type
        if (!read_varint(c, &v)) return false;
        r->v[COL_CLOSE_TYPE] = static_cast<uint32_t>(v);
        break;
      case 15:                                           // signal_source
        if (!read_varint(c, &v)) return false;
        r->v[COL_SIGNAL_SOURCE] = static_cast<uint32_t>(v);
        break;
      case 16:                                           // is_active_service
        if (!read_varint(c, &v)) return false;
        r->v[COL_IS_ACTIVE_SERVICE] = static_cast<uint32_t>(v);
        break;
      case 18:                                           // is_new_flow
        if (!read_varint(c, &v)) return false;
        r->v[COL_IS_NEW_FLOW] = static_cast<uint32_t>(v);
        break;
      case 19:                                           // tap_side
        if (!read_varint(c, &v)) return false;
        r->v[COL_TAP_SIDE] = static_cast<uint32_t>(v);
        break;
      case 20:                                           // syn_seq
        if (!read_varint(c, &v)) return false;
        r->v[COL_SYN_SEQ] = static_cast<uint32_t>(v);
        break;
      case 21:                                           // synack_seq
        if (!read_varint(c, &v)) return false;
        r->v[COL_SYNACK_SEQ] = static_cast<uint32_t>(v);
        break;
      case 22:                                           // last_keepalive_seq
        if (!read_varint(c, &v)) return false;
        r->v[COL_LAST_KEEPALIVE_SEQ] = static_cast<uint32_t>(v);
        break;
      case 23:                                           // last_keepalive_ack
        if (!read_varint(c, &v)) return false;
        r->v[COL_LAST_KEEPALIVE_ACK] = static_cast<uint32_t>(v);
        break;
      case 24:                                           // acl_gids
        // repeated uint32 (packed or not): columnar image keeps the
        // FIRST gid (batch/schema.py acl_gids contract)
        if (wt == 2) {
          Cursor sub2;
          if (!open_sub(c, &sub2)) return false;
          if (sub2.p < sub2.end) {
            if (!read_varint(sub2, &v)) return false;
            if (r->v[COL_ACL_GIDS] == 0)
              r->v[COL_ACL_GIDS] = static_cast<uint32_t>(v);
          }
        } else {
          if (!read_varint(c, &v)) return false;
          if (r->v[COL_ACL_GIDS] == 0)
            r->v[COL_ACL_GIDS] = static_cast<uint32_t>(v);
        }
        break;
      case 25:                                           // direction_score
        if (!read_varint(c, &v)) return false;
        r->v[COL_DIRECTION_SCORE] = static_cast<uint32_t>(v);
        break;
      default:
        if (!skip_field(c, wt)) return false;
    }
  }
  return true;
}

// ingest-derived columns (reference fills these in TaggedFlowToL4FlowLog,
// l4_flow_log.go:857-960): LogMessageStatus from close_type+proto,
// handshake repeats as retransmissions, and the combined l7 error count
inline void derive_l4(Row* r) {
  uint32_t ct = r->v[COL_CLOSE_TYPE];
  uint32_t proto = r->v[COL_PROTO];
  uint32_t status;
  if (ct == 0 || ct == 1) status = 0;                   // forced / FIN
  else if (ct == 3) status = proto == 6 ? 3 : 0;        // timeout
  else if (ct == 2) status = 3;                         // RST
  else status = 2;
  r->v[COL_STATUS] = status;
  if (r->v[COL_SYN_COUNT] > 0)
    r->v[COL_RETRANS_SYN] = r->v[COL_SYN_COUNT] - 1;
  if (r->v[COL_SYNACK_COUNT] > 0)
    r->v[COL_RETRANS_SYNACK] = r->v[COL_SYNACK_COUNT] - 1;
  r->v[COL_L7_ERROR] =
      r->v[COL_L7_CLIENT_ERROR] + r->v[COL_L7_SERVER_ERROR];
}

// Block-buffered column store. Writing one row straight into 93+5 planes
// costs ~98 read-for-ownership misses per record (each store touches a
// plane a megabyte away); measured ~175ns/record on a single core, ~40%
// of total decode time. Instead rows accumulate in an L2-resident
// scratch block and flush per COLUMN: sequential writes per plane that
// the prefetcher can stream (~2x decode speedup at 2^18-row batches).
struct BlockStore {
  static const int BLOCK = 128;
  // column-major scratch: the per-record scatter lands in this ~52 KiB
  // L2-resident block (no DRAM RFOs), and the per-column flush is a pure
  // sequential memcpy on both sides
  uint32_t scratch32[N_COLS32][BLOCK];
  uint64_t scratch64[N_COLS64][BLOCK];
  Row row;                        // decode target
  int fill = 0;
  uint32_t* out32;
  uint64_t* out64;
  long capacity;
  long base;                      // output row index of scratch row 0

  BlockStore(uint32_t* o32, uint64_t* o64, long cap, long start)
      : out32(o32), out64(o64), capacity(cap), base(start) {}

  void flush() {
    for (int col = 0; col < N_COLS32; ++col)
      std::memcpy(out32 + static_cast<size_t>(col) * capacity + base,
                  scratch32[col], sizeof(uint32_t) * fill);
    for (int col = 0; col < N_COLS64; ++col)
      std::memcpy(out64 + static_cast<size_t>(col) * capacity + base,
                  scratch64[col], sizeof(uint64_t) * fill);
    base += fill;
    fill = 0;
  }

  Row* next() { return &row; }

  void commit() {
    for (int col = 0; col < N_COLS32; ++col)
      scratch32[col][fill] = row.v[col];
    for (int col = 0; col < N_COLS64; ++col)
      scratch64[col][fill] = row.v64[col];
    if (++fill == BLOCK) flush();
  }
};

inline bool decode_record(const uint8_t* rec, uint32_t rec_len, Row* r) {
  Cursor c{rec, rec + rec_len};
  std::memset(r, 0, sizeof(*r));
  // TaggedFlow: field 1 = Flow
  bool ok = false;
  uint32_t wt;
  for (uint32_t tag; (tag = next_tag(c, &wt)) != 0; ) {
    if (tag == 1 && wt == 2) {
      Cursor sub;
      if (open_sub(c, &sub) && parse_flow(sub, r)) ok = true;
      else return false;
    } else if (!skip_field(c, wt)) {
      return false;
    }
  }
  if (ok) derive_l4(r);
  return ok;
}

}  // namespace

extern "C" {

// Decode a packed record stream into [N_COLS32, capacity] uint32 planes +
// [N_COLS64, capacity] uint64 planes.
// Returns rows decoded (>= 0); *bad_records counts skipped records.
// Stops early (without error) when capacity is reached; *consumed reports
// how many payload bytes were processed so the caller can continue.
long df_decode_l4(const uint8_t* payload, size_t len, uint32_t* out32,
                  uint64_t* out64, long capacity, long* bad_records,
                  size_t* consumed) {
  long rows = 0;
  *bad_records = 0;
  size_t off = 0;
  BlockStore store(out32, out64, capacity, 0);
  while (off + 4 <= len && rows < capacity) {
    uint32_t rec_len;
    std::memcpy(&rec_len, payload + off, 4);   // little-endian hosts
    off += 4;
    if (off + rec_len > len) {
      // truncated tail: unusable, count once and swallow it
      *bad_records += 1;
      off = len;
      break;
    }
    const uint8_t* rec = payload + off;
    off += rec_len;
    if (!decode_record(rec, rec_len, store.next())) {
      *bad_records += 1;
      continue;
    }
    store.commit();
    ++rows;
  }
  store.flush();
  *consumed = off;
  return rows;
}

// Multi-threaded variant: scans the record length prefixes once (cheap),
// splits the record list across n_threads, each decoding into its own
// disjoint row range of the planes, then compacts the per-thread gaps left
// by bad records. n_threads <= 0 means hardware_concurrency. Semantics
// match df_decode_l4 (capacity bound, *consumed resume point).
long df_decode_l4_mt(const uint8_t* payload, size_t len, uint32_t* out32,
                     uint64_t* out64, long capacity, int n_threads,
                     long* bad_records, size_t* consumed) {
  struct Range { size_t off; uint32_t len; };
  *bad_records = 0;
  std::vector<Range> ranges;
  size_t off = 0;
  long truncated = 0;
  while (off + 4 <= len && static_cast<long>(ranges.size()) < capacity) {
    uint32_t rec_len;
    std::memcpy(&rec_len, payload + off, 4);
    off += 4;
    if (off + rec_len > len) { truncated = 1; off = len; break; }
    ranges.push_back(Range{off, rec_len});
    off += rec_len;
  }
  *consumed = off;
  long n = static_cast<long>(ranges.size());
  if (n_threads <= 0) {
    unsigned hc = std::thread::hardware_concurrency();
    n_threads = hc ? static_cast<int>(hc) : 1;
  }
  if (static_cast<long>(n_threads) > n) n_threads = n ? static_cast<int>(n) : 1;

  // each worker decodes ranges[first..last) into rows starting at `first`,
  // packing its good rows densely within its own region
  auto worker = [&](long first, long last, long* rows_out, long* bad_out) {
    long rows = first;
    BlockStore store(out32, out64, capacity, first);
    for (long i = first; i < last; ++i) {
      if (!decode_record(payload + ranges[i].off, ranges[i].len,
                         store.next())) {
        ++*bad_out;
        continue;
      }
      store.commit();
      ++rows;
    }
    store.flush();
    *rows_out = rows - first;
  };

  std::vector<long> t_rows(n_threads, 0), t_bad(n_threads, 0);
  std::vector<long> t_first(n_threads, 0);
  if (n_threads <= 1) {
    worker(0, n, &t_rows[0], &t_bad[0]);
  } else {
    long per = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t)
      t_first[t] = t * per < n ? t * per : n;
    DecodePool::instance().run(n_threads, [&](int t) {
      long first = t * per;
      long last = first + per < n ? first + per : n;
      if (first >= n) return;
      worker(first, last, &t_rows[t], &t_bad[t]);
    });
  }
  // compact: close the gaps between per-thread row runs
  long rows = n_threads ? t_rows[0] : 0;
  for (int t = 1; t < n_threads; ++t) {
    if (t_rows[t] == 0) continue;
    if (rows != t_first[t]) {
      for (int col = 0; col < N_COLS32; ++col) {
        uint32_t* base = out32 + static_cast<size_t>(col) * capacity;
        std::memmove(base + rows, base + t_first[t],
                     static_cast<size_t>(t_rows[t]) * sizeof(uint32_t));
      }
      for (int col = 0; col < N_COLS64; ++col) {
        uint64_t* base = out64 + static_cast<size_t>(col) * capacity;
        std::memmove(base + rows, base + t_first[t],
                     static_cast<size_t>(t_rows[t]) * sizeof(uint64_t));
      }
    }
    rows += t_rows[t];
  }
  for (int t = 0; t < n_threads; ++t) *bad_records += t_bad[t];
  *bad_records += truncated;
  return rows;
}

int df_n_l4_cols(void) { return N_COLS32; }
int df_n_l4_cols64(void) { return N_COLS64; }

}  // extern "C"
