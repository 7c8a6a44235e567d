// Batched histogram for Hopper (sm_90a), added in place:
// acc[r, clamp(idx[r, j])] += weight(j) for r < d, j < n, acc [d, width]
// int32, idx [d, n] int32, one weight per lane shared across the d rows.
//
// Replaces deepflow_tpu/ops/pallas_hist.py `hist_pallas` (the one-hot
// bf16 matmul into an f32 VMEM accumulator). A scatter-add has no dense
// form worth keeping on Hopper: this kernel counts with int32 atomics,
// exact at any count, straight into the caller's int32 state.
//
// Semantics (state + mxu_hist.hist_masked): indices clamp to [0, width);
// a lane whose mask byte is 0 adds nothing; otherwise its weight is
// min(w, wmax) & wmax with wmax = 256**planes - 1 (the value the
// reference's base-256 digit planes carry), or 1 without weights.
//
// Bound: bytes. idx is read once (d*n*4 B), the weights or the mask once,
// the state read and written once (2*d*width*4 B). One launch does it,
// adding straight into the int32 state:
//
// - Rows that fit one block's shared memory (the entropy width, 2^12
//   bins = 16 KiB): each block keeps a private copy of its row, counts
//   kLanesPerSmemBlock lanes into it with shared-memory atomics (a skewed
//   stream's hot bins stay on the SM) and adds its non-zero bins into
//   `acc` with one atomic (RED) each.
// - Wider rows (the Count-Min width 2^17, DDSketch's 2^19): atomics
//   straight into `acc`, which the 50 MB L2 absorbs, kLanesPerGlobalBlock
//   lanes per block.
//
// Thread-block clusters holding a row in distributed shared memory were
// measured and lost to both paths at both main-path widths on the H100
// (PERF.md): a cluster launch and its barriers cost ~1 us more than a
// plain block, and a remote add issues no faster than a global one.
//
// Every path loads 16 bytes of indices at a time (the unaligned head and
// tail lane by lane), and a thread loads its first lanes before the
// shared copy is zeroed, so the loads' latency overlaps the zeroing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 128 * 1024;   // the widest block-private row
// lanes per block: the best of the launch-shape sweep (PERF.md)
constexpr int kLanesPerSmemBlock = 2048;
constexpr int kLanesPerGlobalBlock = 1024;
constexpr int kPrefetch = 2;   // quads of lanes a thread loads up front

struct Weights {
  const int32_t* w;      // [n] or null (1 per lane)
  const uint8_t* mask;   // [n] bool bytes or null (every lane)
  int32_t wmax;
  __device__ __forceinline__ int32_t operator()(int lane) const {
    if (mask != nullptr && __ldg(mask + lane) == 0) return 0;
    if (w == nullptr) return 1;
    return min(__ldg(w + lane), wmax) & wmax;
  }
};

__device__ __forceinline__ int clamp_bin(int b, int width) {
  return b < 0 ? 0 : (b >= width ? width - 1 : b);
}

// Lanes [lo, hi) of one row: an unaligned head (under 4 lanes), `nvec`
// aligned quads from `vlo` read as int4, a tail (under 4 lanes) at `tlo`.
struct Lanes {
  int lo, hi, head, vlo, nvec, tlo;
};

__device__ __forceinline__ Lanes lanes_of(const int32_t* ridx, int lo,
                                          int hi) {
  Lanes l;
  l.lo = lo;
  l.hi = hi;
  l.head = lo >= hi ? 0 : min(
      (int)(((16 - ((uintptr_t)(ridx + lo) & 15)) & 15) >> 2), hi - lo);
  l.vlo = lo + l.head;
  l.nvec = lo >= hi ? 0 : (hi - l.vlo) >> 2;
  l.tlo = l.vlo + 4 * l.nvec;
  return l;
}

// Four lanes' bins and weights, loaded.
struct Quad {
  int b[4];
  int32_t w[4];
};

__device__ __forceinline__ Quad load_quad(const int32_t* ridx, const Lanes& l,
                                          int i, int width,
                                          const Weights& wf) {
  const int4 q = __ldg(reinterpret_cast<const int4*>(ridx + l.vlo) + i);
  const int j = l.vlo + 4 * i;
  Quad r;
  r.b[0] = clamp_bin(q.x, width);
  r.b[1] = clamp_bin(q.y, width);
  r.b[2] = clamp_bin(q.z, width);
  r.b[3] = clamp_bin(q.w, width);
#pragma unroll
  for (int k = 0; k < 4; ++k) r.w[k] = wf(j + k);
  return r;
}

// Adds into a row: the block's shared copy or the row of `acc`.
struct RowSink {
  int32_t* row;
  __device__ __forceinline__ void operator()(int bin, int32_t v) const {
    atomicAdd(row + bin, v);
  }
};

__device__ __forceinline__ void add_quad(const Quad& q, const RowSink& sink) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (q.w[k] != 0) sink(q.b[k], q.w[k]);
}

// Counts the quads from `first` on, then the head and tail lanes (warp 0).
__device__ __forceinline__ void count_rest(const int32_t* __restrict__ ridx,
                                           const Lanes& l, int first,
                                           int width, const Weights& wf,
                                           const RowSink& sink) {
  for (int i = first + threadIdx.x; i < l.nvec; i += blockDim.x)
    add_quad(load_quad(ridx, l, i, width, wf), sink);
  int j = -1;
  if (threadIdx.x < l.head) j = l.lo + threadIdx.x;
  else if (threadIdx.x >= 4 && threadIdx.x < 4 + l.hi - l.tlo)
    j = l.tlo + threadIdx.x - 4;
  if (j >= 0) {
    const int32_t wt = wf(j);
    if (wt != 0) sink(clamp_bin(__ldg(ridx + j), width), wt);
  }
}

// Lane range [lo, hi) of chunk `c` when a row's n lanes are cut into
// `chunks` pieces of a multiple of 4 lanes.
__device__ __forceinline__ void chunk_range(int n, int chunks, int c,
                                            int* lo, int* hi) {
  const int per = (((n + chunks - 1) / chunks) + 3) & ~3;
  *lo = min(n, c * per);
  *hi = min(n, *lo + per);
}

// grid (chunks, d): block x of row y counts lane chunk x into its own
// copy of the row, then adds the copy's non-zero bins into acc.
__global__ void __launch_bounds__(kThreads)
hist_smem_kernel(const int32_t* __restrict__ idx, Weights wf,
                 int32_t* __restrict__ acc, int n, int width) {
  extern __shared__ int4 smem4[];
  int32_t* smem = reinterpret_cast<int32_t*>(smem4);
  const int row = blockIdx.y;
  const int32_t* ridx = idx + (long long)row * n;
  int lo, hi;
  chunk_range(n, gridDim.x, blockIdx.x, &lo, &hi);
  const Lanes l = lanes_of(ridx, lo, hi);

  Quad pre[kPrefetch];
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k)
    if (threadIdx.x + k * blockDim.x < l.nvec)
      pre[k] = load_quad(ridx, l, threadIdx.x + k * blockDim.x, width, wf);
  const bool vec = (width & 3) == 0;
  if (vec) {
    for (int i = threadIdx.x; i < width / 4; i += blockDim.x)
      smem4[i] = make_int4(0, 0, 0, 0);
  } else {
    for (int i = threadIdx.x; i < width; i += blockDim.x) smem[i] = 0;
  }
  __syncthreads();

  const RowSink sink{smem};
#pragma unroll
  for (int k = 0; k < kPrefetch; ++k)
    if (threadIdx.x + k * blockDim.x < l.nvec) add_quad(pre[k], sink);
  count_rest(ridx, l, kPrefetch * blockDim.x, width, wf, sink);
  __syncthreads();

  int32_t* dst = acc + (long long)row * width;
  if (vec) {
    for (int i = threadIdx.x; i < width / 4; i += blockDim.x) {
      const int4 s = smem4[i];
      int32_t* p = dst + 4 * i;
      if (s.x) atomicAdd(p, s.x);
      if (s.y) atomicAdd(p + 1, s.y);
      if (s.z) atomicAdd(p + 2, s.z);
      if (s.w) atomicAdd(p + 3, s.w);
    }
  } else {
    for (int i = threadIdx.x; i < width; i += blockDim.x)
      if (smem[i]) atomicAdd(dst + i, smem[i]);
  }
}

// grid (chunks, d): block x of row y counts lane chunk x into acc.
__global__ void __launch_bounds__(kThreads)
hist_global_kernel(const int32_t* __restrict__ idx, Weights wf,
                   int32_t* __restrict__ acc, int n, int width) {
  const int row = blockIdx.y;
  const int32_t* ridx = idx + (long long)row * n;
  int lo, hi;
  chunk_range(n, gridDim.x, blockIdx.x, &lo, &hi);
  count_rest(ridx, lanes_of(ridx, lo, hi), 0, width, wf,
             RowSink{acc + (long long)row * width});
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

cudaError_t launch(const int32_t* idx, const Weights& wf, int32_t* acc,
                   int d, int n, int width, cudaStream_t s) {
  const size_t row_bytes = (size_t)width * sizeof(int32_t);
  if (row_bytes <= (size_t)kMaxSmemBytes) {
    static bool smem_set = false;   // the attribute, once per process
    if (!smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          hist_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          kMaxSmemBytes);
      if (err != cudaSuccess) return err;
      smem_set = true;
    }
    const int chunks = (n + kLanesPerSmemBlock - 1) / kLanesPerSmemBlock;
    hist_smem_kernel<<<dim3(chunks, d), kThreads, row_bytes, s>>>(
        idx, wf, acc, n, width);
    return cudaGetLastError();
  }
  int chunks = (n + kLanesPerGlobalBlock - 1) / kLanesPerGlobalBlock;
  const int cap = (4 * sm_count() + d - 1) / d;
  chunks = chunks > cap ? cap : chunks;
  hist_global_kernel<<<dim3(chunks, d), kThreads, 0, s>>>(idx, wf, acc, n,
                                                          width);
  return cudaGetLastError();
}

}  // namespace

// acc: [d, width] int32, added into in place; idx: [d, n] int32; w: [n]
// int32 or null; mask: [n] bool bytes or null; wmax = 256**planes - 1.
// Returns the launch's CUDA error (0 on success). n and d are > 0.
extern "C" int df_hist_add(const void* idx, const void* w, const void* mask,
                           void* acc, int d, int n, int width, int wmax,
                           void* stream) {
  const Weights wf{static_cast<const int32_t*>(w),
                   static_cast<const uint8_t*>(mask), wmax};
  const cudaError_t err =
      launch(static_cast<const int32_t*>(idx), wf, static_cast<int32_t*>(acc),
             d, n, width, static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();   // consumed either way
  return (int)(err != cudaSuccess ? err : last);
}
