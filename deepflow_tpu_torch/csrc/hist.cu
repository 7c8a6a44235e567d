// Batched histogram for Hopper (sm_90a): idx [d, n] int32 -> [d, width]
// float32 counts, weights [n] shared across the d rows.
//
// Replaces deepflow_tpu/ops/pallas_hist.py `hist_pallas` (the one-hot
// bf16 matmul into an f32 VMEM accumulator). A scatter-add has no dense
// form worth keeping on Hopper: this kernel counts with int32 atomics,
// exact at any count, and converts to float32 at the end as the
// reference's `hist` returns.
//
// Semantics (mxu_hist.hist): indices clamp to [0, width); a weight is
// min(w, wmax) & wmax with wmax = 256**planes - 1 (the value the
// reference's base-256 digit planes carry); no weights = 1 per lane.
//
// Bound: bytes. idx is read once (d*n*4 B), weights once (n*4 B), the
// output written once (d*width*4 B). Where one row fits in kSmemMaxBytes
// (entropy: 2^12 bins = 16 KiB), each block takes one row and a chunk of
// kLanesPerBlock lanes, counts into a private copy of that row in shared
// memory and adds its non-zero bins to global memory; wider rows
// (Count-Min: 2^17 bins = 512 KiB) take atomics straight into global
// memory, which the 50 MB L2 absorbs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemMaxBytes = 96 * 1024;    // one row's histogram
constexpr int kLanesPerBlock = 4096;

__device__ __forceinline__ int32_t load_weight(const int32_t* w, int lane,
                                               int32_t wmax) {
  if (w == nullptr) return 1;
  return min(__ldg(w + lane), wmax) & wmax;
}

// Histograms that fit in shared memory: grid (chunks, d), block (x, row)
// counts lanes [x*kLanesPerBlock, ...) of one row into a private copy of
// that row's histogram, then adds its non-zero bins to global memory.
__global__ void __launch_bounds__(kThreads)
hist_smem_kernel(const int32_t* __restrict__ idx, const int32_t* __restrict__ w,
                 int32_t* __restrict__ acc, int n, int width, int32_t wmax) {
  extern __shared__ int32_t smem[];
  const int begin = blockIdx.x * kLanesPerBlock;
  if (begin >= n) return;
  const int end = min(n, begin + kLanesPerBlock);
  const int row = blockIdx.y;
  for (int i = threadIdx.x; i < width; i += blockDim.x) smem[i] = 0;
  __syncthreads();
  const int32_t* ridx = idx + (long long)row * n;
  for (int lane = begin + threadIdx.x; lane < end; lane += blockDim.x) {
    const int32_t wt = load_weight(w, lane, wmax);
    if (wt == 0) continue;
    int b = __ldg(ridx + lane);
    b = b < 0 ? 0 : (b >= width ? width - 1 : b);
    atomicAdd(smem + b, wt);
  }
  __syncthreads();
  int32_t* racc = acc + (long long)row * width;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const int32_t v = smem[i];
    if (v != 0) atomicAdd(racc + i, v);
  }
}

// Wider histograms: grid-stride over the d*n (row, lane) items, atomics
// straight into global memory.
__global__ void __launch_bounds__(kThreads)
hist_global_kernel(const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ w, int32_t* __restrict__ acc,
                   int d, int n, int width, int32_t wmax) {
  const long long total = (long long)d * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const int row = (int)(t / n);
    const int lane = (int)(t - (long long)row * n);
    const int32_t wt = load_weight(w, lane, wmax);
    if (wt == 0) continue;
    int b = __ldg(idx + t);
    b = b < 0 ? 0 : (b >= width ? width - 1 : b);
    atomicAdd(acc + (long long)row * width + b, wt);
  }
}

__global__ void to_float_kernel(const int32_t* __restrict__ acc,
                                float* __restrict__ out, long long m) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < m;
       i += stride)
    out[i] = (float)acc[i];
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

}  // namespace

// acc: [d*width] int32, zeroed by the caller; out: [d*width] float32.
// w may be null (unweighted). Returns cudaGetLastError() after the launches.
extern "C" int df_hist(const void* idx, const void* w, void* acc, void* out,
                       int d, int n, int width, int wmax, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)d * n;
  const long long bins = (long long)d * width;
  const size_t smem = (size_t)width * sizeof(int32_t);
  if (total > 0) {
    if (smem <= (size_t)kSmemMaxBytes) {
      static bool attr_set = false;
      if (!attr_set) {
        cudaFuncSetAttribute(hist_smem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMaxBytes);
        attr_set = true;
      }
      const dim3 grid((n + kLanesPerBlock - 1) / kLanesPerBlock, d);
      hist_smem_kernel<<<grid, kThreads, smem, s>>>(
          static_cast<const int32_t*>(idx), static_cast<const int32_t*>(w),
          static_cast<int32_t*>(acc), n, width, wmax);
    } else {
      long long blocks = (total + kThreads - 1) / kThreads;
      if (blocks > 8LL * sm_count()) blocks = 8LL * sm_count();
      hist_global_kernel<<<(int)blocks, kThreads, 0, s>>>(
          static_cast<const int32_t*>(idx), static_cast<const int32_t*>(w),
          static_cast<int32_t*>(acc), d, n, width, wmax);
    }
  }
  long long cblocks = (bins + kThreads - 1) / kThreads;
  if (cblocks > 8LL * sm_count()) cblocks = 8LL * sm_count();
  if (cblocks > 0)
    to_float_kernel<<<(int)cblocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(acc), static_cast<float*>(out), bins);
  return (int)cudaGetLastError();
}
