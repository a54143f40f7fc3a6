// min_dist: (n,) float32 min squared distance to the valid centers and
// (n,) int32 argmin.
//
// Replaces the TPU kernel repro/kernels/min_dist.py::min_dist_pallas
// (pallas_call at min_dist.py:88), which tiles point panels against
// center panels and drives the cross term through the MXU.
//
// What bounds it on the H100: the work is 2·n·k·d float32 operations on
// n·d inputs, i.e. about k/2 operations per byte of points read. On the
// main path (P2 of eta ~ 17 k rows against k_plus = 103 centers, d = 15)
// that is ~50 flop/byte, above the card's float32 ridge of 67 TFLOP/s over
// 3.35 TB/s (~20 flop/byte), so it is bound by float32 operations, and at
// 17 k points (68 blocks) it fills only half the card and is launch-bound
// in practice.
//
// Design: one thread per point, the point's row in registers, the center
// set streamed through shared memory in 32 KB tiles with ||c||^2 and the
// validity mask staged beside it; every thread reads the same center row,
// so shared-memory reads are float4 broadcasts and each costs one
// instruction per four FMAs. Nothing is carried between blocks, so blocks
// run in any order. A tensor-core (wgmma) cross term is a later step.
#include "common.cuh"

namespace rt {

template <typename T, int DR>
__global__ void __launch_bounds__(kThreads)
    min_dist_kernel(const T* __restrict__ x, long long n, int d,
                    const float* __restrict__ c,
                    const uint8_t* __restrict__ cv, int k, int kt,
                    float* __restrict__ d2, int* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  float best, x2;
  int arg;
  bool any_valid;
  nearest<T, DR>(x + (active ? i : 0) * d, active, d, c, cv, k, kt, smem,
                 best, arg, x2, any_valid);
  if (active) {
    d2[i] = clamp0(best + x2);
    idx[i] = arg;
  }
}

}  // namespace rt

extern "C" int rt_min_dist(const void* x, int dtype, long long n, int d,
                           const float* c, const uint8_t* cv, int k,
                           float* d2, int* idx, void* stream) {
  using namespace rt;
  return (int)dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    const TileShape ts = tile_shape(d, DR, k);
    if (n == 0) return cudaGetLastError();
    const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
    return launch(min_dist_kernel<T, DR>, grid, ts.smem,
                  (cudaStream_t)stream, (const T*)x, n, d, c, cv, k, ts.kt,
                  d2, idx);
  });
}
