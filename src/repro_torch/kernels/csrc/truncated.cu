// truncated_cost: the weighted cost of a center set split at a distance
// threshold v, per machine: the kept cost (min-d2 <= v), and the tail's
// weight mass and cost (min-d2 > v). A row of weight 0 falls on neither
// side.
//
// Replaces repro/kernels/truncated.py::truncated_cost_pallas (pallas_call
// at truncated.py:95), which walks point panels with the center set
// resident in VMEM and accumulates the three scalars in VMEM across the
// grid, writing nothing (n,)-sized. Its caller is kzmeans' scoring pass
// (repro/robust/kzmeans.py:193), one call per machine under a vmap whose
// (m,) triples are psum'd.
//
// What bounds it on the H100: 2·n·k·d float32 operations on n·d + n
// inputs, and 3 floats a machine out. On the kzmeans path (8 machines of
// 1,275,000 rows, d = 15, k = 25) that is ~7.7 GFLOP on ~653 MB: about 12
// operations per byte, under the float32 ridge (~20), so it is bound by
// bytes (~0.195 ms at 3.35 TB/s).
//
// Design: the one-point-a-thread walk (common.cuh: nearest, min_dist's
// arithmetic to the bit) over a grid of (point block, machine), so one
// launch scores every machine; v is read through a device pointer, so a
// threshold computed on the card never waits for the host. Each block
// reduces its three sums in a fixed order (block_sum) into per-block
// partials laid out (machine, 3, blocks), and the fixed-order
// reduce_rows pass adds each row in block order: the same bits on every
// run, and (m, 3) triples out for the caller's psum.
// Nothing in the design depends on the number of centers.
#include "common.cuh"

namespace rt {

template <typename T, int DR>
__global__ void __launch_bounds__(kThreads)
    truncated_kernel(const T* __restrict__ x, long long p, int d,
                     const float* __restrict__ w, const float* __restrict__ c,
                     const uint8_t* __restrict__ cv, int k, int kt,
                     const float* __restrict__ v, float* __restrict__ part,
                     long long nb) {
  extern __shared__ __align__(16) float smem[];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = (long long)blockIdx.y * p + i;
  const bool active = i < p;
  const float vv = *v;
  float best, x2;
  int arg;
  bool any_valid;
  nearest<T, DR>(x + (active ? row : 0) * d, active, d, c, cv, k, kt, smem,
                 best, arg, x2, any_valid);
  float kept = 0.f, tmass = 0.f, tcost = 0.f;
  if (active) {
    const float wi = w[row];
    const float d2 = clamp0(best + x2);
    const float s = wi > 0.f ? wi * d2 : 0.f;    // weight 0: no side
    if (d2 <= vv) {                              // inclusive below, as ref.py
      kept = s;
    } else {
      tmass = wi;
      tcost = s;
    }
  }
  kept = block_sum(kept);
  tmass = block_sum(tmass);
  tcost = block_sum(tcost);
  if (threadIdx.x == 0) {
    float* out = part + (long long)blockIdx.y * 3 * nb + blockIdx.x;
    out[0] = kept;
    out[nb] = tmass;
    out[2 * nb] = tcost;
  }
}

}  // namespace rt

// x is (m, p, d), w (m, p); part holds m * 3 * max(blocks_for(p), 1)
// floats; out holds (m, 3): each machine's kept cost, tail mass and tail
// cost.
extern "C" int rt_truncated_cost(const void* x, int dtype, int m,
                                 long long p, int d, const float* w,
                                 const float* c, const uint8_t* cv, int k,
                                 const float* v, float* part, float* out,
                                 void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long nb = blocks_for(p);
  cudaError_t e = dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    const TileShape ts = tile_shape(d, DR, k);
    if (m == 0 || p == 0) return cudaGetLastError();
    const dim3 grid((unsigned)nb, (unsigned)m);
    return launch(truncated_kernel<T, DR>, grid, ts.smem, s, (const T*)x, p,
                  d, w, c, cv, k, ts.kt, v, part, nb);
  });
  if (e != cudaSuccess) return (int)e;
  if (m == 0) return (int)cudaGetLastError();
  return (int)reduce_rows(part, nb, 3LL * m, out, s);
}
