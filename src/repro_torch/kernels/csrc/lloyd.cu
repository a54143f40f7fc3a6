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
// ~0.033 ms at 3.35 TB/s). This design reads x twice (the bound pass,
// then the reduce): its floor is ~0.065 ms at that shape.
//
// Design: the Lloyd step's reduce (fused_assign.cu) without its walk, at
// every k. Each term w·x_q (and w) becomes an int64 at scale 2^s
// (common.cuh: bound_kernel, shifts, to_fixed_scaled), so the sums are
// exact in any order: they equal ref.py::fixed_point_reduce_ref bit for
// bit, and fused_assign_reduce's sums given its own argmin. Persistent
// blocks walk tiles of 256·P points, the rows in registers at d <= 16
// (common.cuh: Rows); each warp groups its points by center before they
// touch memory (common.cuh: put_point, WarpGroups), and the group
// leaders add into the warp's own shared rows, flushed once a block, when
// k·(d + 1) <= kWarpAccEntries (kzmeans' k = 25: 400 entries), else
// straight into the global accumulators (common.cuh: GroupAcc). An
// assignment outside [0, k), or a weight of 0, adds nothing, as the
// reference's one-hot and segment sum. Launches: one memset
// (accumulators and bound), the bound pass, the reduce, the finalize.
// Launched as programmatic dependents (common.cuh: launch_ex), the
// reduce and the finalize took 3 µs more on an H100 at 1.64 M × 15,
// k = 25 (PERF.md §6): the reduce needs the bound for its first term, so
// nothing overlaps.
// The per-block float partials of every center that this kernel wrote
// before (k·d + k floats a block, each (center, coordinate) pair scanning
// the block's 256 points) are gone.
#include "common.cuh"

namespace rt {

// Points a thread: with no walk the reduce dominates, as in the Lloyd
// step's few-center launch (fused_lloyd.py::points_per_thread), and 3
// blocks an SM, as there.
constexpr int kLloydP = 2;

template <typename T, int DR, int P>
__global__ void __launch_bounds__(kThreads, 3)
    lloyd_reduce_kernel(const T* __restrict__ x, long long n, int d,
                        const float* __restrict__ w,
                        const int* __restrict__ assign, int k,
                        long long tiles, int mode,
                        const unsigned* __restrict__ bound,
                        unsigned long long* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  GroupAcc ga(mode, k, d + 1, smem_raw, acc);
  const Shifts sh = shifts(bound, n);
  const double scx = ldexp(1.0, sh.x);
  const double scw = ldexp(1.0, sh.w);
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Rows<T, DR, P> r(x, n, d, tile * (kThreads * P) + threadIdx.x);
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float wi = r.active[p] ? w[r.idx[p]] : 0.f;
      const int a = r.active[p] ? assign[r.idx[p]] : -1;
      const int key = (wi != 0.f && a >= 0 && a < k) ? a : -1;
      put_point<T, DR, P>(r, p, key, wi, d, scx, scw, ga);
    }
  }
  ga.flush();
}

}  // namespace rt

// out holds k*d + k floats: the (k, d) sums, then the (k,) counts. scratch
// holds (k*(d + 1) + 1) * 8 bytes: the (k, d + 1) int64 accumulators, then
// the bound (kernels/lloyd.py::scratch_bytes). mode is an rt::AccMode
// (kWarpAcc only up to kWarpAccEntries entries); sms is the card's SM
// count (the persistent grid is that many times the blocks an SM holds).
extern "C" int rt_lloyd_reduce(const void* x, int dtype, long long n, int d,
                               const float* w, const int* assign, int k,
                               int mode, int sms, void* scratch,
                               long long scratch_bytes, float* out,
                               void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long entries = (long long)k * (d + 1);
  if (k < 0 || sms < 1 || mode < kGlobalAcc || mode > kWarpAcc ||
      (mode == kWarpAcc && entries > kWarpAccEntries) ||
      (entries + 1) * 8 > scratch_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  unsigned long long* acc = (unsigned long long*)scratch;
  unsigned* bound = (unsigned*)(acc + entries);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (entries + 1) * 8, s);
  if (e != cudaSuccess) return (int)e;
  e = dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    if (n == 0) return cudaGetLastError();
    bound_kernel<T><<<bound_grid(n), kThreads, 0, s>>>((const T*)x, n, d, w,
                                                        bound);
    cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return e1;
    auto kern = lloyd_reduce_kernel<T, DR, kLloydP>;
    const size_t smem = acc_smem(mode, k, d + 1);
    int per_sm = 0;
    e1 = blocks_per_sm(kern, smem, &per_sm);
    if (e1 != cudaSuccess) return e1;
    const long long tiles = point_tiles(n, kLloydP);
    const long long resident = (long long)per_sm * sms;
    kern<<<(unsigned)(tiles < resident ? tiles : resident), kThreads, smem,
           s>>>((const T*)x, n, d, w, assign, k, tiles, mode, bound, acc);
    return cudaGetLastError();
  });
  if (e != cudaSuccess) return (int)e;
  fixed_finalize_kernel<<<grid_for(entries), kThreads, 0, s>>>(acc, k, d, n,
                                                               bound, out);
  return (int)cudaGetLastError();
}
