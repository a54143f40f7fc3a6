// One-sweep fused clustering kernels: remove_below and update_min_dist.
// Each reads the points once and keeps the (n,) distances out of device
// memory where the reference does (repro/kernels/fused_lloyd.py). The
// Lloyd step of the same TPU file, fused_assign_reduce, is fused_assign.cu.
//
// Blocks run in parallel and in no order on the card, so nothing is
// accumulated across blocks the way the Pallas kernels accumulate across
// grid steps under @pl.when(i == 0). Float sums across blocks go through
// per-block partials and a second, fixed-order pass (reduce_rows_kernel):
// no float atomics, so every call gives the same bits on every run. The
// only atomics are the integer survivor counts of remove_below, which are
// exact in any order.
#include "common.cuh"

namespace rt {

// ---------------------------------------------------------------- removal
// Replaces repro/kernels/fused_lloyd.py::remove_below_pallas (pallas_call
// at fused_lloyd.py:305) and remove_below_chunked_pallas (:789).
//
// Bound: on the main path it sweeps all m·p = 10 M points (600 MB of
// float32) against k_plus = 103 centers at d = 15: ~31 GFLOP of float32
// FMAs against 0.6 GB, about 50 flop/byte, so it is bound by float32
// operations (0.46 ms at 67 TFLOP/s) rather than by the 0.18 ms the bytes
// need. Design: min_dist's register-blocked walk (common.cuh:
// nearest_split, one slice: the 10 M points fill the card in every
// cell) over a grid of (point tile, machine), P points a thread; the
// threshold v is read through a device pointer, so the host never waits
// for it; each block counts its survivors (one __syncthreads_count per
// point slot of the thread, summed) and adds them to its machine's int32
// count with one atomicAdd. The (m, p) distance array never exists. Each
// point's d2 is min_dist's to the bit, so the mask is exactly
// alive & (min_dist's d2 > v). Blocks an SM, from ptxas: 110 registers
// at P = 4 (d <= 16), so 2; 72 at P = 2 (any d), so 3.
template <typename T, int DR, int P>
__global__ void __launch_bounds__(kThreads, P <= 2 ? 3 : 2)
    remove_below_kernel(const T* __restrict__ x, long long p, int d,
                        const float* __restrict__ c,
                        const uint8_t* __restrict__ cv, int k, int kt,
                        const float* __restrict__ v,
                        const uint8_t* __restrict__ alive,
                        uint8_t* __restrict__ alive_new,
                        int* __restrict__ live) {
  extern __shared__ __align__(16) float smem[];
  const long long base = (long long)blockIdx.y * p;
  const long long tile = blockIdx.x;
  const Rows<T, DR, P> r(x + base * d, p, d,
                         tile * (kThreads * P) + threadIdx.x);
  float best[P];
  int arg[P];
  nearest_split<T, DR, P>(r, p, d, c, cv, k, k, 0, 1, tile, kt, smem,
                          nullptr, nullptr, nullptr, best, arg);
  const float vv = *v;
  int n_keep = 0;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    int keep = 0;
    if (r.active[q]) {
      const long long row = base + r.idx[q];
      keep = alive[row] && clamp0(best[q] + r.x2[q]) > vv;  // strict >
      alive_new[row] = (uint8_t)keep;
    }
    n_keep += __syncthreads_count(keep);
  }
  if (threadIdx.x == 0 && n_keep) atomicAdd(live + blockIdx.y, n_keep);
}

// ------------------------------------------------------- D² seeding step
// Replaces repro/kernels/fused_lloyd.py::update_min_dist_pallas
// (pallas_call at fused_lloyd.py:370) and its big-n twin
// update_min_dist_pipelined_pallas (fused_lloyd.py:467).
//
// Bound: one new center (kc = 1) against eta ~ 17 k to 81 k rows is
// ~0.1 to 0.5 MB of traffic, which the card moves in well under a
// microsecond, so each call is bound by its two launches; k-means++ makes
// k_plus - 1 of them per seeding. Design: per point min(d2, cand) in one
// pass with the per-block partial of sum w·d2_new written beside it, then
// the fixed-order reduce_rows pass for the mass. "No valid center" is
// decided from the mask itself (as fused_lloyd.py:342-346), and then d2
// passes through bit for bit.
template <typename T, int DR>
__global__ void __launch_bounds__(kThreads)
    update_min_dist_kernel(const T* __restrict__ x, long long n, int d,
                           const float* __restrict__ w,
                           const float* __restrict__ d2,
                           const float* __restrict__ c,
                           const uint8_t* __restrict__ cv, int k, int kt,
                           float* __restrict__ d2_new,
                           float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  float best, x2;
  int arg;
  bool any_valid;
  nearest<T, DR>(x + (active ? i : 0) * d, active, d, c, cv, k, kt, smem,
                 best, arg, x2, any_valid);
  float contrib = 0.f;
  if (active) {
    const float old = d2[i];
    const float cand = clamp0(best + x2);
    const float nw = (any_valid && cand < old) ? cand : old;
    d2_new[i] = nw;
    contrib = w[i] * nw;
  }
  const float s = block_sum(contrib);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

}  // namespace rt

extern "C" int rt_remove_below(const void* x, int dtype, int m, long long p,
                               int d, const float* c, const uint8_t* cv,
                               int k, const float* v, const uint8_t* alive,
                               uint8_t* alive_new, int* live, void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(live, 0, sizeof(int) * (size_t)m, s);
  if (e != cudaSuccess) return (int)e;
  return (int)dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    // min_dist's points a thread: rows in registers, or re-read
    constexpr int P = DR > 0 ? 4 : 2;
    const TileShape ts = tile_shape(d, DR, k);
    if (m == 0 || p == 0) return cudaGetLastError();
    const dim3 grid((unsigned)point_tiles(p, P), (unsigned)m);
    return launch(remove_below_kernel<T, DR, P>, grid, ts.smem, s,
                  (const T*)x, p, d, c, cv, k, ts.kt, v, alive, alive_new,
                  live);
  });
}

// part holds max(blocks_for(n), 1) floats.
extern "C" int rt_update_min_dist(const void* x, int dtype, long long n,
                                  int d, const float* w, const float* d2,
                                  const float* c, const uint8_t* cv, int k,
                                  float* d2_new, float* part, float* mass,
                                  void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long nb = blocks_for(n);
  cudaError_t e = dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    const TileShape ts = tile_shape(d, DR, k);
    if (n == 0) return cudaGetLastError();
    return launch(update_min_dist_kernel<T, DR>, dim3((unsigned)nb), ts.smem,
                  s, (const T*)x, n, d, w, d2, c, cv, k, ts.kt, d2_new, part);
  });
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_rows(part, nb, 1, mass, s);
}
