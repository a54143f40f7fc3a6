// fused_assign_reduce: one Lloyd step over any number of centers — the
// nearest valid center of every point, the weighted (k, d) sums and (k,)
// weight counts per center, and the weighted cost, from one sweep of x.
//
// Replaces, with one kernel at every k:
//   repro/kernels/fused_lloyd.py::fused_assign_reduce_pallas (pallas_call
//     at fused_lloyd.py:150) and its big-n twin
//     fused_assign_reduce_pipelined_pallas (:234): the resident centers;
//   ::fused_assign_reduce_chunked_pallas (:593): center chunks past a
//     point panel with (kp, d) accumulators resident for the walk;
//   ::_fused_assign_reduce_chunked_twopass (:688, :709): its fallback
//     when the accumulators pass 6 MiB.
// On the TPU the three differ in where the accumulators live; here they
// live in device memory as (k, d + 1) int64 fixed-point rows, so their
// size sets no limit and x is read once.
//
// Bound: 2·n·k·d + 2·n·d float32 operations at 67 TFLOP/s, or the bytes
// (n·d points, n weights, k·d centers in; k·d + k + 1 floats out) at
// 3.35 TB/s, whichever is larger: operations from k ≈ 10 up at d = 15
// (1.25 M × 831: 0.466 ms; 65,536 × 173,256: 5.08 ms).
//
// Design, against what held the two kernels it replaces back:
//
// 1. The walk (common.cuh: nearest_blocked). Each thread owns P points
//    (the wrapper's rule: 4 where the walk dominates, 2 with few centers
//    or d > 16; 8 measured no faster than 4), so each center row read
//    from shared memory feeds P·16 FMAs, and its ||c||^2 is read once for
//    the P points; an invalid center carries ||c||^2 = +inf, so the walk
//    has no validity load and no branch. One point a thread spent about
//    as many shared-memory loads and compares as FMAs. Per point the
//    arithmetic is common.cuh's to the bit, so the argmin and min-d2 are
//    the min_dist kernel's.
// 2. The reduce. Each term w·x_q (and w) becomes an int64 at scale 2^s
//    (common.cuh: bound_kernel, shifts, to_fixed_scaled): integer
//    addition is exact and associative, so any grouping gives the same
//    bits, which a plain emulation (kernels/ref.py::
//    fixed_point_reduce_ref) reproduces exactly. Before touching memory
//    each warp groups its points by center (common.cuh: WarpGroups,
//    __match_any_sync and a shuffle tree over each group's lanes;
//    put_point and GroupAcc, shared with lloyd_reduce): one atomicAdd
//    per group and column instead of one per point and column.
//    With few centers (k·(d + 1) <= 1,024 entries) each warp adds its
//    groups into its own shared rows with no atomics, and a persistent
//    block flushes the warps' sum once, one global atomicAdd per non-zero
//    entry: the global atomics no longer meet on a few rows from every
//    point. The resident kernel's per-block partials of every center
//    ((k·d + k + 1) floats a block, scanned with O(rows·k·d) work) and
//    the chunked kernel's atomic per point and coordinate are gone.
// 3. Filling the card. Blocks are persistent (as many as the SMs hold,
//    each walking tiles of 256·P points in turn). When the tiles cannot
//    fill the SMs (the wrapper's rule: fewer than 4 an SM), the center
//    axis is split into S slices of at least 512 centers over grid.y,
//    S chosen to fill the last wave (common.cuh: nearest_split, shared
//    with min_dist). Each block walks one slice for its tile and writes a
//    per-slice (best, arg) (the (S, n) scratch: the only place the (n,)
//    argmin reaches device memory, 5.2 MB at EIM11's 65,536 points and
//    S = 10). The last block of a tile to finish (a counter a tile)
//    combines the slices in slice order with a strict <, which is the
//    first-index argmin of one sequential walk, and then reduces the
//    tile.
// 4. Launches: one memset (accumulators, bound, tile counters), the bound
//    pass (the shift needs max |w| and max |x| before any term is
//    formed: the one extra read of x), the walk, and the finalize (fixed
//    point to float32, and the fixed-order sum of the per-tile cost
//    partials: one float a tile, the same bits every run). Launched as
//    programmatic dependents (common.cuh: launch_ex), the walk and the
//    finalize took 8 µs more on an H100 at 1.25 M × 25 and 15-20 µs more
//    at × 831 (PERF.md §6): they are ordinary launches.
#include "common.cuh"

namespace rt {

// Blocks an SM, by the registers P points take: 3 at P = 2 (80
// registers), 2 at P = 4 (128).
template <typename T, int DR, int P>
__global__ void __launch_bounds__(kThreads, P <= 2 ? 3 : 2)
    fused_assign_kernel(const T* __restrict__ x, long long n, int d,
                        const float* __restrict__ w,
                        const float* __restrict__ c,
                        const uint8_t* __restrict__ cv, int k, int kt,
                        int slice, long long tiles, int mode,
                        long long n_shift,
                        const unsigned* __restrict__ bound,
                        unsigned long long* __restrict__ acc,
                        unsigned* __restrict__ tile_done,
                        float* __restrict__ part,
                        float* __restrict__ ws_best, int* __restrict__ ws_arg,
                        int* __restrict__ assign_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // kWarpAcc: each warp's (k, d + 1) int64 rows, then the center tile
  GroupAcc ga(mode, k, d + 1, smem_raw, acc);
  float* tile_smem =
      reinterpret_cast<float*>(smem_raw + acc_smem(mode, k, d + 1));
  const Shifts sh = shifts(bound, n_shift);
  const double scx = ldexp(1.0, sh.x);
  const double scw = ldexp(1.0, sh.w);

  // Persistent blocks walk the tiles tile, tile + gridDim.x, ... (one
  // tile a block when the center axis is split); each tile's cost is its
  // own partial, so the sum does not depend on the grid.
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const Rows<T, DR, P> r(x, n, d, tile * (kThreads * P) + threadIdx.x);
    float best[P];
    int arg[P];
    if (!nearest_split<T, DR, P>(r, n, d, c, cv, k, slice, blockIdx.y,
                                 gridDim.y, tile, kt, tile_smem, tile_done,
                                 ws_best, ws_arg, best, arg)) {
      continue;                                // uniform over the block
    }

    float cost = 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float wi = r.active[p] ? w[r.idx[p]] : 0.f;
      if (r.active[p]) {
        cost += wi * clamp0(best[p] + r.x2[p]);
        if (assign_out != nullptr) assign_out[r.idx[p]] = arg[p];
      }
      const int key = (r.active[p] && wi != 0.f) ? arg[p] : -1;
      put_point<T, DR, P>(r, p, key, wi, d, scx, scw, ga);
    }
    const float s = block_sum(cost);
    if (threadIdx.x == 0) part[tile] = s;
  }

  ga.flush();                                  // kWarpAcc: once a block
}

template <typename T, int DR, int P>
cudaError_t launch_walk(const T* x, long long n, int d, const float* w,
                        const float* c, const uint8_t* cv, int k, int slices,
                        int mode, long long n_shift, int sms,
                        unsigned char* base, const Scratch& sc,
                        long long tiles, int* assign_out, cudaStream_t s) {
  const int slice = (k + slices - 1) / slices;
  const TileShape ts = tile_shape(d, DR, slice);
  const size_t smem = acc_smem(mode, k, d + 1) + ts.smem;
  auto kern = fused_assign_kernel<T, DR, P>;
  int per_sm = 0;
  const cudaError_t e = blocks_per_sm(kern, smem, &per_sm);
  if (e != cudaSuccess) return e;
  // one tile a block when the center axis is split, else as many
  // persistent blocks as the SMs hold at once
  long long grid = tiles;
  if (slices == 1) {
    const long long resident = (long long)per_sm * sms;
    grid = tiles < resident ? tiles : resident;
  }
  kern<<<dim3((unsigned)grid, (unsigned)slices), kThreads, smem, s>>>(
      x, n, d, w, c, cv, k, ts.kt, slice, tiles, mode, n_shift,
      (const unsigned*)(base + sc.bound),
      (unsigned long long*)(base + sc.acc), (unsigned*)(base + sc.done),
      (float*)(base + sc.part), (float*)(base + sc.best),
      (int*)(base + sc.arg), assign_out);
  return cudaGetLastError();
}

}  // namespace rt

// One Lloyd step. out holds k*d + k + 1 floats: the (k, d) sums, the (k,)
// counts, then the cost. scratch holds scratch_bytes bytes laid out as
// rt::scratch_layout says, for `ppt` points a thread (2 or 4) over
// tiles = max(ceil(n / (256·ppt)), 1) point tiles and `slices` center
// slices. mode is an rt::AccMode: where the groups' totals go; sms is the
// card's SM count (the persistent grid is that many times the blocks an
// SM holds). assign_out, when not NULL, receives the (n,) argmin (a
// check's hook; the step itself needs none).
//
// A step over one part of a larger point set (a mesh rank's rows) takes
// the whole set's bound and row count: bound_in, when not NULL, holds
// rt_fixed_bound's two words over every part (the bound pass is skipped),
// and n_shift (> 0) is the whole set's row count for the shifts. Each
// part's (k, d + 1) int64 accumulators, the first bytes of scratch, then
// add up exactly to the one-call accumulators of the whole set.
extern "C" int rt_fused_assign_reduce(const void* x, int dtype, long long n,
                                      int d, const float* w, const float* c,
                                      const uint8_t* cv, int k, int ppt,
                                      int slices, int mode, int sms,
                                      void* scratch, long long scratch_bytes,
                                      const unsigned* bound_in,
                                      long long n_shift,
                                      int* assign_out, float* out,
                                      void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  if ((ppt != 2 && ppt != 4) || slices < 1 || k < 1 || sms < 1 ||
      mode < kGlobalAcc || mode > kWarpAcc ||
      (mode == kWarpAcc && (long long)k * (d + 1) > kWarpAccEntries)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ns = n_shift > 0 ? n_shift : n;
  const long long tiles = point_tiles(n, ppt);
  const Scratch sc = scratch_layout(n, d, k, tiles, slices);
  if ((long long)sc.total > scratch_bytes) return (int)cudaErrorInvalidValue;
  unsigned char* base = (unsigned char*)scratch;
  cudaError_t e = cudaMemsetAsync(base, 0, sc.zeroed, s);
  if (e != cudaSuccess) return (int)e;
  if (bound_in != nullptr) {
    e = cudaMemcpyAsync(base + sc.bound, bound_in, 2 * sizeof(unsigned),
                        cudaMemcpyDeviceToDevice, s);
    if (e != cudaSuccess) return (int)e;
  }
  e = dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    if (n == 0) return cudaGetLastError();
    if (bound_in == nullptr) {
      bound_kernel<T><<<bound_grid(n), kThreads, 0, s>>>(
          (const T*)x, n, d, w, (unsigned*)(base + sc.bound));
      const cudaError_t e1 = cudaGetLastError();
      if (e1 != cudaSuccess) return e1;
    }
    const T* xt = (const T*)x;
    return ppt == 2
               ? launch_walk<T, DR, 2>(xt, n, d, w, c, cv, k, slices, mode,
                                       ns, sms, base, sc, tiles, assign_out,
                                       s)
               : launch_walk<T, DR, 4>(xt, n, d, w, c, cv, k, slices, mode,
                                       ns, sms, base, sc, tiles, assign_out,
                                       s);
  });
  if (e != cudaSuccess) return (int)e;
  fused_finalize_kernel<<<grid_for((long long)k * (d + 1)), kThreads, 0, s>>>(
      (const unsigned long long*)(base + sc.acc), k, d, ns,
      (const unsigned*)(base + sc.bound), (const float*)(base + sc.part),
      n > 0 ? tiles : 0, out);
  return (int)cudaGetLastError();
}

// The Lloyd step's bound pass alone: bound[0] = max |w_i|, bound[1] =
// max |x_iq| over rows with w_i != 0, as float bits (two words, zeroed
// here). The words of several parts combine by max.
extern "C" int rt_fixed_bound(const void* x, int dtype, long long n, int d,
                              const float* w, unsigned* bound, void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(bound, 0, 2 * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  return (int)dispatch(dtype, d, [&](auto tag, auto) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    if (n == 0) return cudaGetLastError();
    bound_kernel<T><<<bound_grid(n), kThreads, 0, s>>>((const T*)x, n, d, w,
                                                       bound);
    return cudaGetLastError();
  });
}
