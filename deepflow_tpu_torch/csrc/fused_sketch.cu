// Fused unpack + fold + sketch-histogram kernels for Hopper (sm_90a).
//
// Replace deepflow_tpu/ops/pallas_sketch.py `fused_lane_hists` (lane
// kernel `_kernel`) and `fused_news_hists` (`_news_kernel`), which share
// the histogram half `_hist_body`. Here too one __device__ function,
// `hist_body`, holds that half, and a template parameter picks the
// prologue: a (4, C) packed-lane plane or a (6, C) dict-wire news plane.
//
// Per record j < n (n is read from device memory, so the caller never
// syncs to learn it; records j >= n carry weight 0 and are skipped):
//   unpack   ports, proto and packets from the plane words;
//   fold     the 5-tuple into the flow key (utils/u32.fold_columns);
//   CMS      d rows, bucket(fkey, mult_r, salt_r) += 1;
//   entropy  4 features (ip_src, ip_dst, port_src, port_dst),
//            bucket(feat, mult_f, salt_f) += min(pkts, wmax) & wmax.
// The counts are added IN PLACE into the int32 sketch state: there is no
// delta buffer, and int32 atomics are exact at any count (the reference's
// f32 deltas are exact only below 2^24 per cell and batch).
//
// Bound: bytes. The plane is read once (16 B or 24 B per record) and the
// state is read and written once (CMS d x 2^cms_lw int32, entropy
// 4 x 2^ent_lw int32). The CMS adds go straight to global memory (2 MiB at
// the defaults, L2-resident). The grid is (record chunks, 4): block
// (x, f) counts entropy feature f into a private shared-memory copy of
// its row (16 KiB at the defaults), merged with one global atomic per
// non-zero bin, and the Count-Min rows f, f+4, ...; the plane is read
// from L2 by the four blocks of a chunk. Loads are coalesced along C:
// thread j reads column j of each plane row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRecordsPerBlock = 2048;
constexpr int kMaxCmsDepth = 16;
constexpr int kEntFeatures = 4;
constexpr int kSmemMaxBytes = 96 * 1024;
constexpr uint32_t kGolden = 0x9E3779B9u;

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t fold_step(uint32_t h, uint32_t c) {
  return mix32(h ^ (c + kGolden + (h << 6) + (h >> 2)));
}

__device__ __forceinline__ uint32_t bucket(uint32_t x, uint32_t mult,
                                           uint32_t salt, int lw) {
  return (mult * mix32(x ^ salt)) >> (32 - lw);
}

struct Record {
  uint32_t ip_src, ip_dst, port_src, port_dst, proto;
  int32_t pkts;
};

// Lane plane rows: ip_src, ip_dst, port_src<<16|port_dst,
// proto<<24|pkts (flow_suite.unpack_lanes).
// News plane rows: dict index (unused), ip_src, ip_dst, ports, raw proto
// byte, PKTS_CAP'd packets (flow_dict.update_news).
template <bool kNews>
__device__ __forceinline__ Record load_record(const uint32_t* __restrict__ p,
                                              int C, int j) {
  Record r;
  if (!kNews) {
    r.ip_src = __ldg(p + j);
    r.ip_dst = __ldg(p + C + j);
    const uint32_t ports = __ldg(p + 2 * C + j);
    const uint32_t pp = __ldg(p + 3 * C + j);
    r.port_src = ports >> 16;
    r.port_dst = ports & 0xFFFFu;
    r.proto = pp >> 24;
    r.pkts = (int32_t)(pp & 0xFFFFFFu);
  } else {
    r.ip_src = __ldg(p + C + j);
    r.ip_dst = __ldg(p + 2 * C + j);
    const uint32_t ports = __ldg(p + 3 * C + j);
    r.port_src = ports >> 16;
    r.port_dst = ports & 0xFFFFu;
    r.proto = __ldg(p + 4 * C + j) & 0xFFu;
    r.pkts = (int32_t)(__ldg(p + 5 * C + j) & 0xFFFFFFu);
  }
  return r;
}

// The shared histogram half (pallas_sketch._hist_body): one definition
// for both wires. `part` (the block's y index, one of kEntFeatures) picks
// the entropy feature this block counts and the Count-Min rows it owns
// (part, part + kEntFeatures, ...).
__device__ __forceinline__ void hist_body(const Record& r, int part,
                                          const uint32_t* s_cms_seeds,
                                          int cms_d, int cms_lw,
                                          const uint32_t* s_ent_seeds,
                                          int ent_lw, int32_t wmax,
                                          int32_t* __restrict__ cms,
                                          int32_t* ent_row) {
  if (part < cms_d) {
    uint32_t h = kGolden;
    h = fold_step(h, r.ip_src);
    h = fold_step(h, r.ip_dst);
    h = fold_step(h, r.port_src);
    h = fold_step(h, r.port_dst);
    h = fold_step(h, r.proto);
    const int cms_w = 1 << cms_lw;
    for (int row = part; row < cms_d; row += kEntFeatures) {
      const uint32_t b =
          bucket(h, s_cms_seeds[2 * row], s_cms_seeds[2 * row + 1], cms_lw);
      atomicAdd(cms + row * cms_w + (int)b, 1);
    }
  }
  const int32_t wm = min(r.pkts, wmax) & wmax;
  if (wm == 0) return;
  const uint32_t feat = part == 0 ? r.ip_src
                        : part == 1 ? r.ip_dst
                        : part == 2 ? r.port_src : r.port_dst;
  const uint32_t b =
      bucket(feat, s_ent_seeds[2 * part], s_ent_seeds[2 * part + 1], ent_lw);
  atomicAdd(ent_row + (int)b, wm);
}

// grid (chunks, kEntFeatures): block (x, part) takes records
// [x*kRecordsPerBlock, ...) below n, entropy feature `part` (privatized in
// shared memory) and the Count-Min rows of `part`.
template <bool kNews, bool kSharedEnt>
__global__ void __launch_bounds__(kThreads)
fused_hists_kernel(const uint32_t* __restrict__ plane, int C,
                   const int32_t* __restrict__ n_ptr,
                   const uint32_t* __restrict__ cms_seeds, int cms_d,
                   int cms_lw, const uint32_t* __restrict__ ent_seeds,
                   int ent_lw, int32_t wmax, int32_t* __restrict__ cms,
                   int32_t* __restrict__ ent) {
  extern __shared__ int32_t s_ent[];
  __shared__ uint32_t s_cms_seeds[2 * kMaxCmsDepth];
  __shared__ uint32_t s_ent_seeds[2 * kEntFeatures];
  int n = __ldg(n_ptr);
  n = n > C ? C : n;
  const int begin = blockIdx.x * kRecordsPerBlock;
  if (begin >= n) return;               // n is the same for the whole block
  const int end = min(n, begin + kRecordsPerBlock);
  const int part = blockIdx.y;
  const int ent_w = 1 << ent_lw;
  for (int i = threadIdx.x; i < 2 * cms_d; i += blockDim.x)
    s_cms_seeds[i] = cms_seeds[i];
  for (int i = threadIdx.x; i < 2 * kEntFeatures; i += blockDim.x)
    s_ent_seeds[i] = ent_seeds[i];
  if (kSharedEnt)
    for (int i = threadIdx.x; i < ent_w; i += blockDim.x) s_ent[i] = 0;
  __syncthreads();

  int32_t* ent_row = kSharedEnt ? s_ent : ent + part * ent_w;
  for (int j = begin + threadIdx.x; j < end; j += blockDim.x) {
    const Record r = load_record<kNews>(plane, C, j);
    hist_body(r, part, s_cms_seeds, cms_d, cms_lw, s_ent_seeds, ent_lw, wmax,
              cms, ent_row);
  }
  if (kSharedEnt) {
    __syncthreads();
    int32_t* dst = ent + part * ent_w;
    for (int i = threadIdx.x; i < ent_w; i += blockDim.x) {
      const int32_t v = s_ent[i];
      if (v != 0) atomicAdd(dst + i, v);
    }
  }
}

template <bool kNews>
int launch(const void* plane, int C, const void* n_ptr, const void* cms_seeds,
           int cms_d, int cms_lw, const void* ent_seeds, int ent_lw, int wmax,
           void* cms, void* ent, void* stream) {
  if (cms_d < 1 || cms_d > kMaxCmsDepth) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)(1 << ent_lw) * sizeof(int32_t);
  int chunks = (C + kRecordsPerBlock - 1) / kRecordsPerBlock;
  if (chunks < 1) chunks = 1;
  const dim3 blocks(chunks, kEntFeatures);
  const uint32_t* p = static_cast<const uint32_t*>(plane);
  const int32_t* np = static_cast<const int32_t*>(n_ptr);
  const uint32_t* cs = static_cast<const uint32_t*>(cms_seeds);
  const uint32_t* es = static_cast<const uint32_t*>(ent_seeds);
  int32_t* c = static_cast<int32_t*>(cms);
  int32_t* e = static_cast<int32_t*>(ent);
  if (smem <= (size_t)kSmemMaxBytes) {
    static bool attr_set = false;
    if (!attr_set) {
      cudaFuncSetAttribute(fused_hists_kernel<kNews, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemMaxBytes);
      attr_set = true;
    }
    fused_hists_kernel<kNews, true><<<blocks, kThreads, smem, s>>>(
        p, C, np, cs, cms_d, cms_lw, es, ent_lw, wmax, c, e);
  } else {
    fused_hists_kernel<kNews, false><<<blocks, kThreads, 0, s>>>(
        p, C, np, cs, cms_d, cms_lw, es, ent_lw, wmax, c, e);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// plane: (4, C) uint32 lane words; n_ptr: one int32 in device memory;
// seeds: [cms_d, 2] and [4, 2] uint32 (multiplier, salt); cms: [cms_d,
// 2^cms_lw] int32 and ent: [4, 2^ent_lw] int32, both updated in place.
extern "C" int df_fused_lane_hists(const void* plane, int C, const void* n_ptr,
                                   const void* cms_seeds, int cms_d,
                                   int cms_lw, const void* ent_seeds,
                                   int ent_lw, int wmax, void* cms, void* ent,
                                   void* stream) {
  return launch<false>(plane, C, n_ptr, cms_seeds, cms_d, cms_lw, ent_seeds,
                       ent_lw, wmax, cms, ent, stream);
}

// plane: (6, C) uint32 dict-wire news rows; everything else as above.
extern "C" int df_fused_news_hists(const void* plane, int C, const void* n_ptr,
                                   const void* cms_seeds, int cms_d,
                                   int cms_lw, const void* ent_seeds,
                                   int ent_lw, int wmax, void* cms, void* ent,
                                   void* stream) {
  return launch<true>(plane, C, n_ptr, cms_seeds, cms_d, cms_lw, ent_seeds,
                      ent_lw, wmax, cms, ent, stream);
}
