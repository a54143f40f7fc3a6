// min_dist: (n,) float32 min squared distance to the valid centers and
// (n,) int32 argmin.
//
// Replaces the TPU kernel repro/kernels/min_dist.py::min_dist_pallas
// (pallas_call at min_dist.py:88), which tiles point panels against
// center panels and drives the cross term through the MXU.
//
// What bounds it on the H100: the work is 2·n·k·d float32 operations on
// n·d inputs, i.e. about k/2 operations per byte of points read, above
// the card's float32 ridge of 67 TFLOP/s over 3.35 TB/s (~20 flop/byte)
// from k ≈ 40 up: bound by float32 operations at every shape that costs
// time (k-means‖'s 1.25 M × 831 and 3,081 rows: 0.466 and 1.725 ms;
// EIM11's sweeps of 1 M points against a clustering that grows by
// 14,438 rows a round). At SOCCER's coordinator shapes (17 k points ×
// 103 centers) it is bound by its launch and the host.
//
// Design, by width (the wrapper's rule: kernels/walk.py):
// - d <= 16: the register-blocked walk shared with the Lloyd step
//   (common.cuh: nearest_split). Each thread owns 4 points, their rows in
//   registers, so each center row read from shared memory as float4
//   broadcasts feeds 4·16 FMAs, and an invalid center carries
//   ||c||^2 = +inf (no validity load, no branch). When the point tiles
//   cannot fill the card (EIM11's 14,438-row sample against its whole
//   clustering) the center axis is split over grid.y into slices of at
//   least 512 centers, and the last block of each tile combines the
//   per-slice (best, arg) in slice order. With one slice a call is one
//   launch and touches no scratch.
// - d > 16: the tiled walk shared with the Lloyd step (common.cuh:
//   tiled_nearest), one launch of one block a tile of 128 points, each
//   against every center 80 at a time: the points and the centers both
//   streamed through shared memory, 8 × 5 (point, center) dots a thread,
//   so each row is read from device memory once per 80 centers (the
//   register-blocked walk at d > 16 re-read a point's row for every
//   center, 32 scattered rows a warp: 0.5% of its bound at d = 7,168,
//   PERF.md §6). At kimi-k2's 43,106 × 78 × 7,168 it is bound by float32
//   operations (0.72 ms); what holds it near 40% of that is shared-memory
//   traffic (13 words a thread for 40 FMAs a coordinate) and the wave of
//   337 tiles over 132 SMs at 2 blocks an SM. No center split: no
//   workload at d > 16 has too few point tiles to fill the card.
// Per point the arithmetic is common.cuh's to the bit on both walks, so
// the d2 and argmin are those of every kernel on them and of the
// seeding step.
#include "common.cuh"

namespace rt {

// Blocks an SM, from the registers ptxas gives each instance (nvcc
// -Xptxas -v, printed by chip_smoke.py): 118 at P = 4 (d <= 16), so 2
// blocks of 256 threads. Forcing 3 blocks caps it at 80 registers,
// spills, and runs 24% slower at 1.25 M × 831 on the H100 (PERF.md).
template <typename T, int DR, int P>
__global__ void __launch_bounds__(kThreads, 2)
    min_dist_kernel(const T* __restrict__ x, long long n, int d,
                    const float* __restrict__ c,
                    const uint8_t* __restrict__ cv, int k, int kt, int slice,
                    unsigned* __restrict__ tile_done,
                    float* __restrict__ ws_best, int* __restrict__ ws_arg,
                    float* __restrict__ d2, int* __restrict__ idx) {
  extern __shared__ __align__(16) float smem[];
  const long long tile = blockIdx.x;
  const Rows<T, DR, P> r(x, n, d, tile * (kThreads * P) + threadIdx.x);
  float best[P];
  int arg[P];
  if (!nearest_split<T, DR, P>(r, n, d, c, cv, k, slice, blockIdx.y,
                               gridDim.y, tile, kt, smem, tile_done, ws_best,
                               ws_arg, best, arg)) {
    return;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (r.active[p]) {
      d2[r.idx[p]] = clamp0(best[p] + r.x2[p]);
      idx[r.idx[p]] = arg[p];
    }
  }
}

// d > 16: the tiled walk (common.cuh: tiled_nearest), one block a tile of
// kTilePoints points; lane tx = i of point group ty writes its point i.
// 2 blocks an SM: 128 registers (the 40 accumulators, 5 center float4s
// and a point's float4 live at once), no spills in float32.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    tiled_min_dist_kernel(const T* __restrict__ x, long long n, int d,
                          const float* __restrict__ c,
                          const uint8_t* __restrict__ cv, int k, bool xvec,
                          bool cvec, float* __restrict__ d2,
                          int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TiledSmem& sm = *reinterpret_cast<TiledSmem*>(smem_raw);
  const long long p0 = (long long)blockIdx.x * kTilePoints;
  float best[kTiledPPT];
  int arg[kTiledPPT];
  tiled_nearest<T>(x, n, d, c, cv, k, p0, xvec, cvec, sm, best, arg);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < kTiledPPT; ++i) {
    const int r = ty + kTiledRows * i;         // the point in the tile
    if (tx == i && p0 + r < n) {
      d2[p0 + r] = clamp0(best[i] + sm.x2[r]);
      idx[p0 + r] = arg[i];
    }
  }
}

}  // namespace rt

// ppt is the points a thread, slices the center slices (the wrapper's
// rules: kernels/walk.py); ppt must be the walk's own for the width
// (kTiledPPT on the tiled walk, which takes one slice), which the tiles
// and the scratch depend on. With slices > 1, scratch holds
// kernels/walk.py::split_scratch_bytes bytes: the tile counters, then the
// (slices, n) per-slice best and arg; with one slice it may be NULL.
extern "C" int rt_min_dist(const void* x, int dtype, long long n, int d,
                           const float* c, const uint8_t* cv, int k, int ppt,
                           int slices, void* scratch, float* d2, int* idx,
                           void* stream) {
  using namespace rt;
  if (slices < 1 || (slices > 1 && !scratch)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned char* base = (unsigned char*)scratch;
  return (int)dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    if constexpr (DR == 0) {
      if (ppt != kTiledPPT || slices != 1) return cudaErrorInvalidValue;
      if (n == 0) return cudaGetLastError();
      const bool xvec = copies16<T>(x, d);
      const bool cvec = copies16<float>(c, d);
      return launch(tiled_min_dist_kernel<T>, dim3((unsigned)tiled_tiles(n)),
                    sizeof(TiledSmem), s, (const T*)x, n, d, c, cv, k, xvec,
                    cvec, d2, idx);
    } else {
      constexpr int P = 4;                       // rows in registers
      if (ppt != P) return cudaErrorInvalidValue;   // the wrapper's tiles
      if (n == 0) return cudaGetLastError();
      const long long tiles = point_tiles(n, P);
      const int slice = (k + slices - 1) / slices;
      const TileShape ts = tile_shape(DR, slice);
      unsigned* done = nullptr;
      float* ws_best = nullptr;
      int* ws_arg = nullptr;
      if (slices > 1) {
        done = (unsigned*)base;
        ws_best = (float*)(base + round8((size_t)tiles * 4));
        ws_arg = (int*)(base + round8((size_t)tiles * 4) +
                        round8((size_t)slices * n * 4));
        const cudaError_t e = cudaMemsetAsync(done, 0, (size_t)tiles * 4, s);
        if (e != cudaSuccess) return e;
      }
      return launch(min_dist_kernel<T, DR, P>,
                    dim3((unsigned)tiles, (unsigned)slices), ts.smem, s,
                    (const T*)x, n, d, c, cv, k, ts.kt, slice, done, ws_best,
                    ws_arg, d2, idx);
    }
  });
}
