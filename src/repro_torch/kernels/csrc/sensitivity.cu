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
// (~20), so it is bound by bytes (~0.027 ms at 3.35 TB/s); at SOCCER
// k = 1000's width (1,111 centers) by operations.
//
// Design, one kernel at every k:
// 1. The walk is min_dist's (common.cuh: nearest_split; the launch shape
//    from kernels/walk.py: P points a thread, the center axis split over
//    blocks where the point tiles cannot fill the card), so the argmin and
//    min-d2 are min_dist's bit for bit. Each point's score
//    w·clamp0(best + ||x||^2) and argmin are written out.
// 2. The masses are exact fixed-point sums of w (common.cuh:
//    to_fixed_scaled at the shift of n·max|w|, from a pass over w alone,
//    max_abs_kernel), so they equal kernels/exact.py::exact_index_add(w,
//    argmin, k) bit for bit, whatever the grid. Each warp groups its
//    points by center (WarpGroups); the leaders add into the warp's shared
//    rows, flushed once a block, when k <= kWarpAccEntries, else into the
//    global int64 accumulators (GroupAcc). The two modes time within 2%
//    of each other from k = 256 to 1,024 (PERF.md §6), where the walk
//    dominates.
// 3. The cost: one float partial a point tile (block_sum), added in tile
//    order by the finalize (common.cuh: fused_finalize_kernel).
// A point is only ever assigned to a valid center, so invalid centers get
// no mass; with no valid center at all every point gets +inf and center 0,
// and center 0 takes the whole mass, as the plain version (kernels/ref.py)
// does. Launches: one memset (accumulators, bound, tile counters), the
// pass over w, the walk, the finalize. The walk is launched while the pass
// over w runs (common.cuh: launch_ex) and waits for its bound only
// after the search, before the masses; the finalize is launched after
// the walk the same way.
#include "common.cuh"

namespace rt {

// Blocks an SM as min_dist's walk: 2 at P = 4, 3 at P = 2.
template <typename T, int DR, int P>
__global__ void __launch_bounds__(kThreads, P <= 2 ? 3 : 2)
    sensitivity_kernel(const T* __restrict__ x, long long n, int d,
                       const float* __restrict__ w,
                       const float* __restrict__ c,
                       const uint8_t* __restrict__ cv, int k, int kt,
                       int slice, int mode,
                       const unsigned* __restrict__ bound,
                       unsigned long long* __restrict__ acc,
                       unsigned* __restrict__ tile_done,
                       float* __restrict__ part, float* __restrict__ ws_best,
                       int* __restrict__ ws_arg, float* __restrict__ scores,
                       int* __restrict__ assign) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // kWarpAcc: each warp's (k,) int64 masses, then the center tile
  GroupAcc ga(mode, k, 1, smem_raw, acc);
  float* tile_smem =
      reinterpret_cast<float*>(smem_raw + acc_smem(mode, k, 1));
  const long long tile = blockIdx.x;
  const Rows<T, DR, P> r(x, n, d, tile * (kThreads * P) + threadIdx.x);
  float best[P];
  int arg[P];
  const bool mine = nearest_split<T, DR, P>(r, n, d, c, cv, k, slice,
                                            blockIdx.y, gridDim.y, tile, kt,
                                            tile_smem, tile_done, ws_best,
                                            ws_arg, best, arg);
  wait_prerequisites();                        // the pass over w
  if (!mine) return;                           // uniform over the block
  const double scw = ldexp(1.0, shifts(bound, n).w);
  float cost = 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float wi = r.active[p] ? w[r.idx[p]] : 0.f;
    if (r.active[p]) {
      const float score = wi * clamp0(best[p] + r.x2[p]);
      scores[r.idx[p]] = score;
      assign[r.idx[p]] = arg[p];
      cost += score;
    }
    const int key = (r.active[p] && wi != 0.f) ? arg[p] : -1;
    const WarpGroups g(key);
    unsigned long long v[1] = {key >= 0 ? to_fixed_scaled((double)wi, scw)
                                        : 0ull};
    g.sum(v);
    if (g.leader) ga.put(key, 0, v[0]);
  }
  const float s = block_sum(cost);
  if (threadIdx.x == 0) part[tile] = s;
  ga.flush();
}

}  // namespace rt

// out holds k + 1 floats: the (k,) masses, then the cost. ppt is the
// points a thread and slices the center slices (kernels/walk.py's rules;
// ppt must be the walk's own P for the width). scratch holds scratch_bytes
// bytes laid out as rt::scratch_layout(n, 0, k, tiles, slices) says
// (kernels/fused_lloyd.py::scratch_bytes with d = 0); mode is an
// rt::AccMode for k entries.
extern "C" int rt_sensitivity_scores(const void* x, int dtype, long long n,
                                     int d, const float* w, const float* c,
                                     const uint8_t* cv, int k, int ppt,
                                     int slices, int mode, void* scratch,
                                     long long scratch_bytes, float* scores,
                                     int* assign, float* out, void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  if (slices < 1 || k < 1 || mode < kGlobalAcc || mode > kWarpAcc ||
      (mode == kWarpAcc && k > kWarpAccEntries)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long tiles = point_tiles(n, ppt);
  const Scratch sc = scratch_layout(n, 0, k, tiles, slices);
  if ((long long)sc.total > scratch_bytes) return (int)cudaErrorInvalidValue;
  unsigned char* base = (unsigned char*)scratch;
  cudaError_t e = cudaMemsetAsync(base, 0, sc.zeroed, s);
  if (e != cudaSuccess) return (int)e;
  e = dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    constexpr int P = DR > 0 ? 4 : 2;  // rows in registers, or re-read
    if (ppt != P) return cudaErrorInvalidValue;   // the wrapper's tiles
    if (n == 0) return cudaGetLastError();
    unsigned* bound = (unsigned*)(base + sc.bound);
    max_abs_kernel<<<max_abs_grid(n), kThreads, 0, s>>>(w, n, bound);
    const cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return e1;
    const int slice = (k + slices - 1) / slices;
    const TileShape ts = tile_shape(d, DR, slice);
    return launch_ex(true, sensitivity_kernel<T, DR, P>,
                     dim3((unsigned)tiles, (unsigned)slices),
                     acc_smem(mode, k, 1) + ts.smem, s, (const T*)x, n, d, w,
                     c, cv, k, ts.kt, slice, mode, (const unsigned*)bound,
                     (unsigned long long*)(base + sc.acc),
                     (unsigned*)(base + sc.done), (float*)(base + sc.part),
                     (float*)(base + sc.best), (int*)(base + sc.arg), scores,
                     assign);
  });
  if (e != cudaSuccess) return (int)e;
  return (int)launch_ex(n > 0, fused_finalize_kernel, dim3(grid_for(k)), 0,
                        s, (const unsigned long long*)(base + sc.acc),
                        (long long)k, 0, (long long)n,
                        (const unsigned*)(base + sc.bound),
                        (const float*)(base + sc.part), n > 0 ? tiles : 0ll,
                        out);
}
