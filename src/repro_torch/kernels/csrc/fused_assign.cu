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
// 1. The walk. At d <= 16 the register-blocked walk (common.cuh:
//    nearest_blocked): each thread owns P points (the wrapper's rule: 4
//    where the walk dominates, 2 with few centers; 8 measured no faster
//    than 4), so each center row read from shared memory feeds P·16
//    FMAs, and its ||c||^2 is read once for the P points; an invalid
//    center carries ||c||^2 = +inf, so the walk has no validity load and
//    no branch. One point a thread spent about as many shared-memory
//    loads and compares as FMAs. At d > 16 the tiled walk (common.cuh:
//    tiled_nearest, tiled_assign_kernel below): 128 points against 80
//    centers a block, both staged through shared memory, where the
//    register-blocked walk re-read each point's row for every center
//    (159.9 ms at kimi-k2's 43,106 × 78 × 7,168, PERF.md §6). Per point
//    the arithmetic is common.cuh's to the bit on both walks, so the
//    argmin and min-d2 are the min_dist kernel's.
// 2. The reduce. Each term w·x_q (and w) becomes an int64 at scale 2^s
//    (common.cuh: bound_kernel, shifts, to_fixed_scaled): integer
//    addition is exact and associative, so any grouping gives the same
//    bits, which a plain emulation (kernels/ref.py::
//    fixed_point_reduce_ref) reproduces exactly. At d <= 16, before
//    touching memory each warp groups its points by center (common.cuh:
//    WarpGroups, __match_any_sync and a shuffle tree over each group's
//    lanes; put_point and GroupAcc, shared with lloyd_reduce): one
//    atomicAdd per group and column instead of one per point and column.
//    With few centers (k·(d + 1) <= 1,024 entries) each warp adds its
//    groups into its own shared rows with no atomics, and a persistent
//    block flushes the warps' sum once, one global atomicAdd per non-zero
//    entry: the global atomics no longer meet on a few rows from every
//    point. The resident kernel's per-block partials of every center
//    ((k·d + k + 1) floats a block, scanned with O(rows·k·d) work) and
//    the chunked kernel's atomic per point and coordinate are gone. At
//    d > 16 the reduce goes by column, not by point (column_reduce_kernel
//    below): the walk writes the (n,) argmin, and a second kernel gives
//    each block a slab of columns, a few centers and a split of the
//    points, summing in shared memory with no atomics and flushing once
//    (the warp groups' one atomic per group and column, 7,169 columns at
//    d = 7,168, and their uncoalesced row reads took ~8 ms there).
// 3. Filling the card (d <= 16). Blocks are persistent (as many as the
//    SMs hold, each walking tiles of 256·P points in turn). When the
//    tiles cannot fill the SMs (the wrapper's rule: fewer than 4 an SM),
//    the center axis is split into S slices of at least 512 centers over
//    grid.y, S chosen to fill the last wave (common.cuh: nearest_split,
//    shared with min_dist). Each block walks one slice for its tile and
//    writes a per-slice (best, arg) (the (S, n) scratch: the only place
//    the (n,) argmin reaches device memory at d <= 16, 5.2 MB at EIM11's
//    65,536 points and S = 10). The last block of a tile to finish (a
//    counter a tile) combines the slices in slice order with a strict <,
//    which is the first-index argmin of one sequential walk, and then
//    reduces the tile.
// 4. Launches: one memset (accumulators, bound, tile counters), the bound
//    pass (the shift needs max |w| and max |x| before any term is
//    formed: the one extra read of x), the walk (at d > 16 the tiled walk,
//    then the column reduce: one more read of x), and the finalize (fixed
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
  const TileShape ts = tile_shape(DR, slice);
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

// d > 16, the walk: the tiled walk (common.cuh: tiled_nearest), one block
// a tile of kTilePoints points, writing each point's argmin and the
// tile's cost partial (its points' w·d2 summed by block_sum in point
// order). 2 blocks an SM at 128 registers (84 bytes of spills in float32,
// outside the walk's loop).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    tiled_assign_kernel(const T* __restrict__ x, long long n, int d,
                        const float* __restrict__ w,
                        const float* __restrict__ c,
                        const uint8_t* __restrict__ cv, int k, bool xvec,
                        bool cvec, float* __restrict__ part,
                        int* __restrict__ assign) {
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
    if (tx == i) {
      float cost = 0.f;
      if (p0 + r < n) {
        assign[p0 + r] = arg[i];
        cost = w[p0 + r] * clamp0(best[i] + sm.x2[r]);
      }
      sm.part[r] = cost;
    }
  }
  __syncthreads();
  const float s = block_sum(threadIdx.x < kTilePoints ? sm.part[threadIdx.x]
                                                       : 0.f);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// d > 16, the reduce, by column. A block owns a slab of kColSlab columns
// of the (d + 1)-wide rows (4 adjacent ones a thread; the last column is
// w), a range of kr centers and a split of the points; its (kr, kColSlab)
// int64 accumulators sit in shared memory (column 4·t + c of thread t at
// c·kThreads + t: a warp's 64-bit adds meet no bank twice), each entry in
// one thread only, so they are added with no atomics. Each warp reads 32
// points' argmin and weights at a time, and takes those of its range with
// w != 0 eight at a time: their 128 columns of each row (512 coalesced bytes at
// float32, one 16-byte load a lane where d % 4 == 0 and the base is
// aligned), each term rounded once to an int64 (to_fixed_scaled). The
// block then makes one global atomicAdd a non-zero entry. Integer sums:
// the accumulators hold put_point's bits.
constexpr int kColSlab = 4 * kThreads;   // columns a block
constexpr int kRangeCenters = 8;         // centers a block's range, at most
constexpr long long kSplitMin = 1024;    // points a split, at least

// The reduce's grid (kernels/fused_lloyd.py::reduce_grid mirrors it): the
// slabs over d + 1 columns, even ranges of at most kRangeCenters centers
// over k, and the fewest splits of at least kSplitMin points that bring
// the blocks to 4 an SM.
struct ColumnGrid {
  int slabs, ranges, kr, splits;
  long long split;
};

inline ColumnGrid column_grid(long long n, int d, int k, int sms) {
  ColumnGrid g;
  g.slabs = (d + 1 + kColSlab - 1) / kColSlab;
  g.ranges = (k + kRangeCenters - 1) / kRangeCenters;
  g.kr = (k + g.ranges - 1) / g.ranges;
  const long long cells = (long long)g.slabs * g.ranges;
  long long splits = (4ll * sms + cells - 1) / cells;
  const long long most = (n + kSplitMin - 1) / kSplitMin;
  splits = splits < most ? splits : most;
  g.splits = (int)(splits > 1 ? splits : 1);
  g.split = (n + g.splits - 1) / g.splits;
  return g;
}

// Four coordinates q .. q + 3 of row i (0 past d); vec: one aligned load.
template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ x, long long i,
                                      int d, int q, bool vec, float (&v)[4]) {
  const T* p = x + i * d + q;
  if (vec && q < d) {
    if constexpr (std::is_same<T, float>::value) {
      const float4 f = *reinterpret_cast<const float4*>(p);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      v[0] = widen_bits<T>((unsigned short)(u.x & 0xffffu));
      v[1] = widen_bits<T>((unsigned short)(u.x >> 16));
      v[2] = widen_bits<T>((unsigned short)(u.y & 0xffffu));
      v[3] = widen_bits<T>((unsigned short)(u.y >> 16));
    }
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) v[c] = q + c < d ? widen(p[c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    column_reduce_kernel(const T* __restrict__ x, long long n, int d,
                         bool vec, const float* __restrict__ w,
                         const int* __restrict__ assign, int k, int kr,
                         long long split, long long n_shift,
                         const unsigned* __restrict__ bound,
                         unsigned long long* __restrict__ acc) {
  extern __shared__ __align__(16) unsigned long long sacc[];
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kBatch = 8;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kColSlab + 4 * threadIdx.x;   // 4 columns
  const int k0 = blockIdx.y * kr;
  const int k1 = min(k, k0 + kr);
  const long long lo = (long long)blockIdx.z * split;
  const long long hi = min(n, lo + split);
  for (int e = threadIdx.x; e < kr * kColSlab; e += kThreads) sacc[e] = 0ull;
  __syncthreads();
  const Shifts sh = shifts(bound, n_shift);
  const double scx = ldexp(1.0, sh.x);
  const double scw = ldexp(1.0, sh.w);
  if (q - 4 * lane <= d) {                     // the warp has a column
    for (long long i0 = lo; i0 < hi; i0 += 32) {
      const long long i = i0 + lane;
      int key = -1;
      float wi = 0.f;
      if (i < hi) {
        key = assign[i];
        wi = w[i];
      }
      unsigned take = __ballot_sync(kFull, wi != 0.f && key >= k0 &&
                                               key < k1);
      while (take) {                           // uniform over the warp
        int b[kBatch];
        float v[kBatch][4];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          b[u] = take ? __ffs(take) - 1 : -1;
          take &= take - 1u;
          if (b[u] >= 0) {
            load4(x, i0 + b[u], d, q, vec, v[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (b[u] < 0) break;
          const int kb = __shfl_sync(kFull, key, b[u]);
          const double wd = (double)__shfl_sync(kFull, wi, b[u]);
          // x·(w·2^s) is the exact w·x·2^s of put_point: one rounding
          const double ws = wd * scx;
          unsigned long long* row =
              sacc + (kb - k0) * kColSlab + threadIdx.x;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            row[c * kThreads] +=
                q + c < d ? to_fixed_scaled((double)v[u][c], ws)
                          : (q + c == d ? to_fixed_scaled(wd, scw) : 0ull);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kr * kColSlab; e += kThreads) {
    const int j = e / kColSlab;
    const int r = e - j * kColSlab;            // = c·kThreads + thread
    const int qe = blockIdx.x * kColSlab + 4 * (r % kThreads) + r / kThreads;
    const unsigned long long t = sacc[e];
    if (k0 + j < k1 && qe <= d && t != 0ull) {
      atomicAdd(acc + (long long)(k0 + j) * (d + 1) + qe, t);
    }
  }
}

// The tiled walk, then the column reduce over its argmin (into
// assign_out when given, else the scratch's).
template <typename T>
cudaError_t launch_tiled(const T* x, long long n, int d, const float* w,
                         const float* c, const uint8_t* cv, int k,
                         long long n_shift, int sms, unsigned char* base,
                         const Scratch& sc, long long tiles, int* assign_out,
                         cudaStream_t s) {
  const bool xvec = copies16<T>(x, d);
  const bool cvec = copies16<float>(c, d);
  int* assign = assign_out != nullptr ? assign_out
                                      : (int*)(base + sc.assign);
  cudaError_t e = launch(tiled_assign_kernel<T>, dim3((unsigned)tiles),
                         sizeof(TiledSmem), s, x, n, d, w, c, cv, k, xvec,
                         cvec, (float*)(base + sc.part), assign);
  if (e != cudaSuccess) return e;
  const ColumnGrid g = column_grid(n, d, k, sms);
  if (g.ranges > 65535) return cudaErrorInvalidValue;
  const bool rvec = d % 4 == 0 && (uintptr_t)x % (4 * sizeof(T)) == 0;
  return launch(column_reduce_kernel<T>,
                dim3((unsigned)g.slabs, (unsigned)g.ranges,
                     (unsigned)g.splits),
                (size_t)g.kr * kColSlab * 8, s, x, n, d, rvec, w,
                (const int*)assign, k, g.kr, g.split, n_shift,
                (const unsigned*)(base + sc.bound),
                (unsigned long long*)(base + sc.acc));
}

}  // namespace rt

// One Lloyd step. out holds k*d + k + 1 floats: the (k, d) sums, the (k,)
// counts, then the cost. scratch holds scratch_bytes bytes laid out as
// rt::scratch_layout says: at d <= 16 for `ppt` points a thread (2 or 4)
// over tiles = max(ceil(n / (256·ppt)), 1) point tiles and `slices`
// center slices; at d > 16 for the tiled walk (ppt = kTiledPPT, one
// slice, tiled_tiles(n) tiles) with the (n,) argmin last. mode is an
// rt::AccMode: where the groups' totals go (d <= 16; the column reduce
// keeps its own); sms is the card's SM count (the persistent grid is that
// many times the blocks an SM holds; the column reduce's grid brings its
// blocks to 4 an SM). assign_out, when not NULL, receives the (n,)
// argmin (a check's hook; at d > 16 the column reduce then reads it
// there).
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
  const bool tiled = d > 16;                   // by_width's DR = 0 instance
  if ((tiled ? (ppt != kTiledPPT || slices != 1)
             : (ppt != 2 && ppt != 4)) ||
      slices < 1 || k < 1 || sms < 1 ||
      mode < kGlobalAcc || mode > kWarpAcc ||
      (mode == kWarpAcc && (long long)k * (d + 1) > kWarpAccEntries)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long ns = n_shift > 0 ? n_shift : n;
  const long long tiles = tiled ? tiled_tiles(n) : point_tiles(n, ppt);
  const Scratch sc = scratch_layout(n, d, k, tiles, slices, tiled ? n : 0);
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
    if constexpr (DR == 0) {
      return launch_tiled<T>(xt, n, d, w, c, cv, k, ns, sms, base, sc, tiles,
                             assign_out, s);
    } else {
      return ppt == 2
                 ? launch_walk<T, DR, 2>(xt, n, d, w, c, cv, k, slices, mode,
                                         ns, sms, base, sc, tiles,
                                         assign_out, s)
                 : launch_walk<T, DR, 4>(xt, n, d, w, c, cv, k, slices, mode,
                                         ns, sms, base, sc, tiles,
                                         assign_out, s);
    }
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
