// sensitivity_scores: the coreset builder's scoring sweep. For each point
// its score w·min-d2 and its nearest valid center; per center the weight
// mass of its points; and the weighted cost of the center set.
//
// Replaces repro/kernels/sensitivity.py::sensitivity_scores_pallas
// (pallas_call at sensitivity.py:99), which walks point panels with the
// center set resident in VMEM, writes the (n,) scores and assignment, and
// accumulates the (k,) masses through a weighted one-hot and the cost in
// VMEM across the grid. Its caller is coresets/sensitivity.py:60
// (build_coreset, on every machine of coreset_kmeans, kzmeans and SOCCER's
// uplink_mode="coreset").
//
// What bounds it on the H100: 2·n·k·d float32 operations on n·d + n
// inputs, and 2n outputs. On the kzmeans path (1,275,000 rows per machine
// against kb = 25 bicriteria centers at d = 15) that is ~1 GFLOP on
// ~92 MB: about 10 operations per byte, under the card's float32 ridge
// (~20), so it is bound by bytes (~0.027 ms at 3.35 TB/s).
//
// Design: the one-point-a-thread walk (common.cuh: nearest, min_dist's
// arithmetic to the bit; the center set streamed through shared memory),
// then per point the score and argmin written out, and the block's
// masses and cost as per-block
// partials (common.cuh: center_partials, counts only, and block_sum) that
// the fixed-order reduce_rows pass adds in block order: the same bits on
// every run. A point is only ever assigned to a valid center, so invalid
// centers get no mass; with no valid center at all every point gets +inf
// and center 0, and center 0 takes the whole mass, as the plain version
// (kernels/ref.py) does.
#include "common.cuh"

namespace rt {

template <typename T, int DR>
__global__ void __launch_bounds__(kThreads)
    sensitivity_kernel(const T* __restrict__ x, long long n, int d,
                       const float* __restrict__ w,
                       const float* __restrict__ c,
                       const uint8_t* __restrict__ cv, int k, int kt,
                       float* __restrict__ scores, int* __restrict__ assign,
                       float* __restrict__ part, long long nb) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int sa[kThreads];
  __shared__ float sw[kThreads];
  const long long base = (long long)blockIdx.x * blockDim.x;
  const long long i = base + threadIdx.x;
  const bool active = i < n;
  float best, x2;
  int arg;
  bool any_valid;
  nearest<T, DR>(x + (active ? i : 0) * d, active, d, c, cv, k, kt, smem,
                 best, arg, x2, any_valid);
  float score = 0.f;
  sa[threadIdx.x] = active ? arg : -1;
  sw[threadIdx.x] = active ? w[i] : 0.f;
  if (active) {
    score = sw[threadIdx.x] * clamp0(best + x2);
    scores[i] = score;
    assign[i] = arg;
  }
  __syncthreads();
  const int rows = (int)min((long long)blockDim.x, n - base);
  center_partials((const T*)nullptr, base, rows, d, k, sa, sw, false, part,
                  nb);
  const float s = block_sum(score);
  if (threadIdx.x == 0) part[(long long)k * nb + blockIdx.x] = s;
}

}  // namespace rt

// part holds (k + 1) * max(blocks_for(n), 1) floats; out holds k + 1: the
// (k,) masses, then the cost.
extern "C" int rt_sensitivity_scores(const void* x, int dtype, long long n,
                                     int d, const float* w, const float* c,
                                     const uint8_t* cv, int k, float* scores,
                                     int* assign, float* part, float* out,
                                     void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long nb = blocks_for(n);
  cudaError_t e = dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    const TileShape ts = tile_shape(d, DR, k);
    if (n == 0) return cudaGetLastError();
    return launch(sensitivity_kernel<T, DR>, dim3((unsigned)nb), ts.smem, s,
                  (const T*)x, n, d, w, c, cv, k, ts.kt, scores, assign, part,
                  nb);
  });
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_rows(part, nb, (long long)k + 1, out, s);
}
