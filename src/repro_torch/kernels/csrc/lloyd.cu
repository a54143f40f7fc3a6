// lloyd_reduce: the weighted per-center (k, d) sums and (k,) counts of one
// Lloyd step, given the (n,) assignment instead of searching for it.
//
// Replaces repro/kernels/lloyd.py::lloyd_reduce_pallas (pallas_call at
// lloyd.py:58), which builds a (bn, k) weighted one-hot per point panel and
// drives the (k, bn) @ (bn, d) product through the MXU into VMEM-resident
// accumulators. Its caller is kzmeans' trimmed Lloyd step
// (repro/robust/kzmeans.py:171), whose weights come from a trim of the
// gathered rows between the assignment and the reduction, so the step
// cannot use fused_assign_reduce.
//
// What bounds it on the H100: n·d + 2n inputs read once and (k·d + k)
// floats written, 2·n·d operations: about one operation per byte, so it is
// bound by bytes (1.64 M rows at d = 15 on the kzmeans path: ~111 MB,
// ~0.033 ms at 3.35 TB/s).
//
// Design: a reduce over the assignment read from memory. Up to
// ops.MAX_RESIDENT_K centers, each block stages its points' centers and weights
// in shared memory and writes per-block partials of the (k·d + k) sums
// (common.cuh: center_partials), which the fixed-order reduce_rows pass
// adds in block order: no atomics, the same bits on every run, and no
// integer atomics meeting on a few rows at small k (kzmeans runs k = 25).
// Beyond the limit the partials would need (k·d + k)·blocks floats, so the
// sums go into (k, d + 1) fixed-point int64 accumulators instead
// (common.cuh: bound_kernel, add_fixed, fixed_finalize_kernel; the scheme
// of fused_assign.cu), exact in any order. An assignment outside [0, k)
// adds nothing, as the reference's one-hot and segment sum.
#include "common.cuh"

namespace rt {

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lloyd_reduce_kernel(const T* __restrict__ x, long long n, int d,
                        const float* __restrict__ w,
                        const int* __restrict__ assign, int k,
                        float* __restrict__ part, long long nb) {
  __shared__ int sa[kThreads];
  __shared__ float sw[kThreads];
  const long long base = (long long)blockIdx.x * blockDim.x;
  const long long i = base + threadIdx.x;
  const bool active = i < n;
  sa[threadIdx.x] = active ? assign[i] : -1;
  sw[threadIdx.x] = active ? w[i] : 0.f;
  __syncthreads();
  const int rows = (int)min((long long)blockDim.x, n - base);
  center_partials(x, base, rows, d, k, sa, sw, true, part, nb);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    lloyd_reduce_fixed_kernel(const T* __restrict__ x, long long n, int d,
                              const float* __restrict__ w,
                              const int* __restrict__ assign, int k,
                              const unsigned* __restrict__ bound,
                              unsigned long long* __restrict__ acc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float wi = w[i];
  const int a = assign[i];
  if (wi == 0.f || a < 0 || a >= k) return;
  add_fixed(acc + (long long)a * (d + 1), x + i * d, d, wi, shifts(bound, n));
}

}  // namespace rt

// out holds k*d + k floats: the (k, d) sums, then the (k,) counts.
// fixed == 0: part holds (k*d + k) * max(blocks_for(n), 1) floats, bound
// and acc are unused. fixed != 0: bound holds 2 uint32 and acc k*(d+1)
// int64, part is unused.
extern "C" int rt_lloyd_reduce(const void* x, int dtype, long long n, int d,
                               const float* w, const int* assign, int k,
                               int fixed, float* part, unsigned* bound,
                               unsigned long long* acc, float* out,
                               void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long nb = blocks_for(n);
  if (!fixed) {
    cudaError_t e = by_dtype(dtype, [&](auto tag) -> cudaError_t {
      using T = std::remove_pointer_t<decltype(tag)>;
      if (n == 0) return cudaGetLastError();
      lloyd_reduce_kernel<T><<<(unsigned)nb, kThreads, 0, s>>>(
          (const T*)x, n, d, w, assign, k, part, nb);
      return cudaGetLastError();
    });
    if (e != cudaSuccess) return (int)e;
    return (int)reduce_rows(part, nb, (long long)k * d + k, out, s);
  }
  cudaError_t e = cudaMemsetAsync(bound, 0, 2 * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * (size_t)k * (d + 1),
                      s);
  if (e != cudaSuccess) return (int)e;
  e = by_dtype(dtype, [&](auto tag) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    if (n == 0) return cudaGetLastError();
    bound_kernel<T><<<bound_grid(n), kThreads, 0, s>>>((const T*)x, n, d, w,
                                                        bound);
    const cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return e1;
    lloyd_reduce_fixed_kernel<T><<<(unsigned)nb, kThreads, 0, s>>>(
        (const T*)x, n, d, w, assign, k, (const unsigned*)bound, acc);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return (int)e;
  fixed_finalize_kernel<<<grid_for((long long)k * (d + 1)), kThreads, 0,
                          s>>>(acc, k, d, n, bound, out);
  return (int)cudaGetLastError();
}
