// fused_assign_reduce for center sets beyond the resident limit (k > 1024):
// one Lloyd step over any number of centers. Returns the (k, d) weighted
// sums, the (k,) weight counts and the weighted cost, as the resident
// kernel in fused_lloyd.cu does.
//
// Replaces repro/kernels/fused_lloyd.py::fused_assign_reduce_chunked_pallas
// (pallas_call at fused_lloyd.py:593) and its two-walk fallback
// _fused_assign_reduce_chunked_twopass (pallas_calls at :688 and :709). On
// the TPU the two differ only in where the (kp, d) accumulators live: in
// VMEM for the whole walk when they fit in 6 MiB (_CHUNK_ACC_BUDGET), else
// one center chunk at a time over a second walk of x. Here one design
// serves both regimes: the accumulators live in device memory, so their
// size sets no limit, and x is read once.
//
// Why the resident kernel's reduction does not carry over: its per-block
// partials are (k·d + k + 1)·ceil(n/256) floats, about 1 GB at 3,081
// centers and 1.25 M points (k-means‖ at k = 100) and about 43 GB at
// 173,256 centers (EIM11). Float atomicAdd into (k, d) would keep the
// scratch small but give other bits on every run: float addition is not
// associative, and atomics land in no fixed order.
//
// Design, fixed-point accumulation (chosen over a counting sort by center,
// which needs an (n,) assignment, a scan and a placement pass, because it
// is one sweep of x with scratch of (k, d + 1) int64 alone; common.cuh
// holds the fixed-point pieces, shared with lloyd_reduce beyond the
// resident limit):
//   1. bound_kernel: max |w| and max |x| over the weighted points.
//   2. chunked_assign_reduce_kernel: the nearest valid center of each
//      point (common.cuh: the center set streams through shared memory in
//      tiles with a running (min, argmin), the walk the TPU kernel makes
//      over center chunks), then add_fixed: each term w·x_q scaled by 2^s
//      to an int64 and added into the point's (k, d + 1) accumulator row
//      with an integer atomicAdd — the same bits whatever order the
//      blocks run in.
//   3. fixed_finalize_kernel: acc·2^-s, converted to float32.
// The cost keeps the per-block partials and the fixed-order reduce_rows
// pass of the resident kernel (one float per block).
//
// Bound: the assignment is 2·n·k·d float32 operations on n·d inputs, at
// thousands of operations per byte of points, so it is bound by float32
// operations (k-means‖ at k = 100: 1.25 M points × ~3 k centers, ~1 ms at
// 67 TFLOP/s per machine); the atomics add n·(d + 1) integer additions
// spread over k rows.
#include "common.cuh"

namespace rt {

template <typename T, int DR>
__global__ void __launch_bounds__(kThreads)
    chunked_assign_reduce_kernel(const T* __restrict__ x, long long n, int d,
                                 const float* __restrict__ w,
                                 const float* __restrict__ c,
                                 const uint8_t* __restrict__ cv, int k,
                                 int kt, const unsigned* __restrict__ bound,
                                 unsigned long long* __restrict__ acc,
                                 float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  const T* xrow = x + (active ? i : 0) * d;
  float best, x2;
  int arg;
  bool any_valid;
  nearest<T, DR>(xrow, active, d, c, cv, k, kt, smem, best, arg, x2,
                 any_valid);
  float cost = 0.f;
  if (active) {
    const float wi = w[i];
    cost = wi * clamp0(best + x2);
    if (wi != 0.f) {
      add_fixed(acc + (long long)arg * (d + 1), xrow, d, wi, shifts(bound, n));
    }
  }
  const float s = block_sum(cost);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

}  // namespace rt

// bound holds 2 uint32, acc k*(d+1) int64, part max(blocks_for(n), 1)
// floats; out holds k*d + k + 1 floats: the (k, d) sums, the (k,) counts,
// then the cost.
extern "C" int rt_fused_assign_reduce_chunked(
    const void* x, int dtype, long long n, int d, const float* w,
    const float* c, const uint8_t* cv, int k, unsigned* bound,
    unsigned long long* acc, float* part, float* out, void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(bound, 0, 2 * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * (size_t)k * (d + 1),
                      s);
  if (e != cudaSuccess) return (int)e;
  const long long nb = blocks_for(n);
  e = dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    if (n == 0) return cudaGetLastError();
    bound_kernel<T><<<grid_for(n * d), kThreads, 0, s>>>((const T*)x, n, d, w,
                                                        bound);
    const cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return e1;
    const TileShape ts = tile_shape(d, DR, k);
    return launch(chunked_assign_reduce_kernel<T, DR>, dim3((unsigned)nb),
                  ts.smem, s, (const T*)x, n, d, w, c, cv, k, ts.kt,
                  (const unsigned*)bound, acc, part);
  });
  if (e != cudaSuccess) return (int)e;
  fixed_finalize_kernel<<<grid_for((long long)k * (d + 1)), kThreads, 0,
                          s>>>(acc, k, d, n, bound, out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_rows(part, nb, 1, out + (long long)k * d + k, s);
}
