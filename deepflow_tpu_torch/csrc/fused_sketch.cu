// Fused unpack + fold + sketch-histogram kernels for Hopper (sm_90a).
//
// Replace deepflow_tpu/ops/pallas_sketch.py `fused_lane_hists` (lane
// kernel `_kernel`) and `fused_news_hists` (`_news_kernel`), which share
// the histogram half `_hist_body`. Here too one __device__ function,
// `hist_body`, holds that half, and a template parameter picks the
// prologue: a (4, C) packed-lane plane or a (6, C) dict-wire news plane.
//
// Per record j < n (n is read from device memory, so the caller never
// syncs to learn it; records j >= n count nothing):
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
// 4 x 2^ent_lw int32). Design:
// - one thread per record: it loads the record once (coalesced along C:
//   thread j reads column j of each plane row), folds the 5-tuple once and
//   issues all d Count-Min adds and all 4 entropy adds;
// - the Count-Min adds are atomics (RED) into the L2-resident state
//   (2 MiB at the defaults);
// - the 4 entropy rows (64 KiB at the defaults) are counted in a copy in
//   each block's shared memory and merged into `ent` once per block, one
//   atomic (RED) per non-zero bin: a skewed stream's hot entropy bins (a
//   few service ports) stay on the SM. Batches of at most
//   kGlobalEntropyRecords records, too small to pay for zeroing and
//   merging the copy, and entropy rows too wide for one block's shared
//   memory add straight into `ent` instead. Thread-block clusters sharing
//   one copy in distributed shared memory lost to both on the H100, on
//   uniform and Zipf(1.1) planes (PERF.md);
// - one block per kThreads records, at most one block per SM (a block
//   then loops), sized from C and the SM count;
// - a thread loads its first record before the shared copy is zeroed,
//   so the load's latency overlaps the zeroing and the barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCmsDepth = 16;
constexpr int kMaxLog2Width = 27;   // keeps (row << lw) + bin in an int
constexpr int kEntFeatures = 4;
constexpr int kMaxSmemBytes = 128 * 1024;   // the widest shared copy
// On the card global entropy atomics beat the shared copy at 8192
// records and lost 1.8x to it on Zipf planes at 32768 (PERF.md).
constexpr int kGlobalEntropyRecords = 8192;
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
// for both wires. `ent_rows` is the block's shared copy of the 4 entropy
// rows, or `ent` itself.
__device__ __forceinline__ void hist_body(const Record& r,
                                          const uint32_t* s_cms_seeds,
                                          int cms_d, int cms_lw,
                                          const uint32_t* s_ent_seeds,
                                          int ent_lw, int32_t wmax,
                                          int32_t* __restrict__ cms,
                                          int32_t* ent_rows) {
  uint32_t h = kGolden;
  h = fold_step(h, r.ip_src);
  h = fold_step(h, r.ip_dst);
  h = fold_step(h, r.port_src);
  h = fold_step(h, r.port_dst);
  h = fold_step(h, r.proto);
  for (int row = 0; row < cms_d; ++row) {
    const uint32_t b =
        bucket(h, s_cms_seeds[2 * row], s_cms_seeds[2 * row + 1], cms_lw);
    atomicAdd(cms + (row << cms_lw) + (int)b, 1);
  }
  const int32_t wm = min(r.pkts, wmax) & wmax;
  if (wm == 0) return;
  const uint32_t feats[kEntFeatures] = {r.ip_src, r.ip_dst, r.port_src,
                                        r.port_dst};
#pragma unroll
  for (int f = 0; f < kEntFeatures; ++f) {
    const uint32_t b =
        bucket(feats[f], s_ent_seeds[2 * f], s_ent_seeds[2 * f + 1], ent_lw);
    atomicAdd(ent_rows + (f << ent_lw) + (int)b, wm);
  }
}

// grid (blocks): block b takes records [b*per, (b+1)*per) below n. kLocal:
// the block counts the entropy adds into its own copy of the 4 rows
// (dynamic shared memory) and merges it into `ent`; otherwise they go
// straight into `ent`.
template <bool kNews, bool kLocal>
__global__ void __launch_bounds__(kThreads)
fused_hists_kernel(const uint32_t* __restrict__ plane, int C,
                   const int32_t* __restrict__ n_ptr,
                   const uint32_t* __restrict__ cms_seeds, int cms_d,
                   int cms_lw, const uint32_t* __restrict__ ent_seeds,
                   int ent_lw, int32_t wmax, int32_t* __restrict__ cms,
                   int32_t* __restrict__ ent) {
  extern __shared__ int4 s_raw[];
  __shared__ uint32_t s_cms_seeds[2 * kMaxCmsDepth];
  __shared__ uint32_t s_ent_seeds[2 * kEntFeatures];
  int n = __ldg(n_ptr);
  n = n > C ? C : n;
  const int per = (C + gridDim.x - 1) / gridDim.x;
  const int begin = blockIdx.x * per;
  if (begin >= n) return;   // the whole block leaves together
  const int end = min(n, begin + per);

  const int quads = kLocal ? 1 << ent_lw : 0;   // 4 rows in int4s
  const int first = begin + threadIdx.x;
  Record r0;
  if (first < end) r0 = load_record<kNews>(plane, C, first);
  for (int i = threadIdx.x; i < 2 * cms_d; i += blockDim.x)
    s_cms_seeds[i] = cms_seeds[i];
  for (int i = threadIdx.x; i < 2 * kEntFeatures; i += blockDim.x)
    s_ent_seeds[i] = ent_seeds[i];
  for (int i = threadIdx.x; i < quads; i += blockDim.x)
    s_raw[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  int32_t* ent_rows = kLocal ? reinterpret_cast<int32_t*>(s_raw) : ent;
  if (first < end)
    hist_body(r0, s_cms_seeds, cms_d, cms_lw, s_ent_seeds, ent_lw, wmax, cms,
              ent_rows);
  for (int j = first + blockDim.x; j < end; j += blockDim.x)
    hist_body(load_record<kNews>(plane, C, j), s_cms_seeds, cms_d, cms_lw,
              s_ent_seeds, ent_lw, wmax, cms, ent_rows);
  if (!kLocal) return;
  __syncthreads();

  for (int i = threadIdx.x; i < quads; i += blockDim.x) {
    const int4 v = s_raw[i];
    int32_t* p = ent + 4 * i;
    if (v.x) atomicAdd(p, v.x);
    if (v.y) atomicAdd(p + 1, v.y);
    if (v.z) atomicAdd(p + 2, v.z);
    if (v.w) atomicAdd(p + 3, v.w);
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

template <bool kNews, bool kLocal>
cudaError_t launch_with(const void* plane, int C, const void* n_ptr,
                        const void* cms_seeds, int cms_d, int cms_lw,
                        const void* ent_seeds, int ent_lw, int wmax,
                        void* cms, void* ent, cudaStream_t s) {
  const size_t smem =
      kLocal ? ((size_t)kEntFeatures << ent_lw) * sizeof(int32_t) : 0;
  if (kLocal) {
    static bool smem_set = false;   // the attribute, once per process
    if (!smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          fused_hists_kernel<kNews, kLocal>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
  }
  int blocks = (C + kThreads - 1) / kThreads;
  blocks = blocks > sm_count() ? sm_count() : blocks;
  fused_hists_kernel<kNews, kLocal><<<blocks, kThreads, smem, s>>>(
      static_cast<const uint32_t*>(plane), C,
      static_cast<const int32_t*>(n_ptr),
      static_cast<const uint32_t*>(cms_seeds), cms_d, cms_lw,
      static_cast<const uint32_t*>(ent_seeds), ent_lw, (int32_t)wmax,
      static_cast<int32_t*>(cms), static_cast<int32_t*>(ent));
  return cudaGetLastError();
}

template <bool kNews>
int launch(const void* plane, int C, const void* n_ptr, const void* cms_seeds,
           int cms_d, int cms_lw, const void* ent_seeds, int ent_lw, int wmax,
           void* cms, void* ent, void* stream) {
  if (cms_d < 1 || cms_d > kMaxCmsDepth || C < 1 || ent_lw < 1 ||
      cms_lw < 1 || ent_lw > kMaxLog2Width || cms_lw > kMaxLog2Width)
    return (int)cudaErrorInvalidValue;
  const bool local =
      C > kGlobalEntropyRecords &&
      ((size_t)kEntFeatures << ent_lw) * sizeof(int32_t) <=
          (size_t)kMaxSmemBytes;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      local ? launch_with<kNews, true>(plane, C, n_ptr, cms_seeds, cms_d,
                                       cms_lw, ent_seeds, ent_lw, wmax, cms,
                                       ent, s)
            : launch_with<kNews, false>(plane, C, n_ptr, cms_seeds, cms_d,
                                        cms_lw, ent_seeds, ent_lw, wmax, cms,
                                        ent, s);
  const cudaError_t last = cudaGetLastError();   // consumed either way
  return (int)(err != cudaSuccess ? err : last);
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
