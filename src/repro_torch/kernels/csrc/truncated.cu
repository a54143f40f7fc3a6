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
// bytes (~0.195 ms at 3.35 TB/s); at 1,111 centers by operations.
//
// Design, one kernel at every k:
// 1. The walk is min_dist's (common.cuh: nearest_split; the launch shape
//    from kernels/walk.py: P points a thread, the center axis split over
//    blocks where the point tiles cannot fill the card). The work items
//    are (machine, point tile, center slice): a tile never straddles two
//    machines, and the slices come from the m·tiles tiles of the whole
//    launch. So each point's d2, and with it its side of v, is min_dist's
//    bit for bit.
// 2. A tile's rows (kThreads·P·d·itemsize contiguous bytes: 61,440 at
//    float32, P = 4, d = 15) are staged into shared memory by one TMA bulk
//    copy against an mbarrier (common.cuh: bulk_copy), aligned down to 16
//    bytes where a machine's base is not. The whole tile is in flight at
//    once and coalesced, and no thread spends instructions on addresses;
//    the threads then build their Rows from shared memory (rows of d = 15
//    float32 are an odd number of words apart: no bank conflicts), and
//    at d > 16 (DR == 0) re-read them from there for every center. A tile
//    of more than kStageMax bytes (d > 48 at float32) is read in place
//    from device memory instead, as min_dist reads it.
//    One wave of blocks (the occupancy query's 2 an SM at P = 4) walks the
//    items in a grid-stride loop over one stage: at d <= 16 the stage is
//    refilled with the block's next tile as soon as the rows are in
//    registers, so that copy is in flight while this tile is walked (the
//    register file is the second buffer: two 61 KB stages would hold one
//    block an SM); at d > 16 it is refilled after the walk. Where one
//    slice fits one center tile (k <= 512 at d <= 16) the tile is loaded
//    once a block, not once an item. PERF.md §6 has the times of
//    the arrangements measured against this one.
// 3. Each tile's three sums go through one fixed-order float partial
//    (block_sum) laid out (machine, 3, tiles), and the fixed-order
//    reduce_rows pass adds each row in tile order: the same bits on every
//    run, and (m, 3) triples out for the caller's psum.
// v is read through a device pointer, so a threshold computed on the card
// never waits for the host. With no valid center every d2 is +inf, so
// every point falls in the tail, as the plain version (kernels/ref.py)
// gives.
#include "common.cuh"

namespace rt {

constexpr int kStageMax = 96 * 1024;   // bytes of rows a staged tile, at most

// The scratch of a call, in bytes from its start: the (m, 3, tiles) tile
// partials, then, with more than one center slice, the m·tiles tile
// counters (zeroed by one memset) and the (m, slices, p) per-slice best
// (kernels/truncated.py::scratch_bytes mirrors it). No argmin is kept.
struct TruncScratch {
  size_t part, done, best, total;
};

inline TruncScratch trunc_scratch(int m, long long p, long long tiles,
                                  int slices) {
  TruncScratch s;
  s.part = 0;
  s.done = round8((size_t)m * 3 * tiles * 4);
  const bool split = slices > 1;
  s.best = s.done + (split ? round8((size_t)m * tiles * 4) : 0);
  s.total = s.best + (split ? round8((size_t)slices * m * p * 4) : 0);
  return s;
}

// Items of (machine j, point tile t, center slice s), tile = j·tiles + t,
// item = tile·slices + s, in a grid-stride loop. sbytes is the stage's
// bytes, 0 where the rows are read in place. Blocks an SM as min_dist's
// walk.
template <typename T, int DR, int P>
__global__ void __launch_bounds__(kThreads, P <= 2 ? 3 : 2)
    truncated_kernel(const T* __restrict__ x, long long p, int d,
                     const float* __restrict__ w, const float* __restrict__ c,
                     const uint8_t* __restrict__ cv, int k, int kt,
                     int slice, int slices, long long tiles,
                     long long items, int sbytes,
                     const float* __restrict__ v,
                     unsigned* __restrict__ tile_done,
                     float* __restrict__ ws_best, float* __restrict__ part) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  constexpr int kTile = kThreads * P;          // points a tile
  const bool staged_rows = sbytes > 0;
  const bool resident = slices == 1 && k <= kt;  // one center tile, kept
  unsigned char* stage = smem_u8;
  float* sc = reinterpret_cast<float*>(smem_u8 + sbytes);
  __shared__ __align__(8) unsigned long long full;   // the stage landed
  if (staged_rows && threadIdx.x == 0) {
    barrier_init(&full);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto rows_of = [&](long long item, long long& j, long long& r0) {
    j = item / slices / tiles;
    r0 = (item / slices - j * tiles) * kTile;
  };
  // One thread stages item `it`'s rows, if there is such an item.
  auto stage_item = [&](long long it) {
    if (it >= items) return;
    long long j, r0;
    rows_of(it, j, r0);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(x + (j * p + r0) * d);
    const long long nbytes =
        min((long long)kTile, p - r0) * d * (long long)sizeof(T);
    barrier_expect(&full, aligned_len(src, nbytes));
    bulk_copy(stage, src, nbytes, &full);
  };

  if (staged_rows && threadIdx.x == 0) stage_item(blockIdx.x);
  if (resident) load_center_tile(c, cv, d, DR > 0 ? DR : d, 0, k, kt, sc);
  const float vv = *v;
  unsigned phase = 0u;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    long long j, r0;
    rows_of(it, j, r0);
    const long long tile = it / slices;
    const T* xm = x + j * p * d;
    const T* src = xm;
    long long lo = 0;
    if (staged_rows) {
      barrier_wait(&full, phase);              // the tile's rows landed
      phase ^= 1u;
      src = staged<T>(stage, xm + r0 * d);
      lo = r0;
    }
    const Rows<T, DR, P> r(src, lo, p, d, r0 + threadIdx.x);
    if (DR > 0 && staged_rows) {
      __syncthreads();                         // every row in registers
      if (threadIdx.x == 0) stage_item(it + gridDim.x);
    }
    float best[P];
    int arg[P];
    bool mine = true;
    if (resident) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        best[q] = INFINITY;
        arg[q] = 0;
      }
      scan_center_tile<T, DR, P, false>(r, d, 0, k, kt, sc, best, arg);
    } else {
      mine = nearest_split<T, DR, P, false>(
          r, p, d, c, cv, k, slice, (int)(it - tile * slices), slices, tile,
          kt, sc, tile_done, slices > 1 ? ws_best + j * slices * p : nullptr,
          nullptr, best, arg);
    }
    if (mine) {                                // uniform over the block
      const float* wm = w + j * p;
      float kept = 0.f, tmass = 0.f, tcost = 0.f;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (!r.active[q]) continue;
        const float wi = wm[r.idx[q]];
        const float d2 = clamp0(best[q] + r.x2[q]);
        const float sq = wi > 0.f ? wi * d2 : 0.f;   // weight 0: no side
        if (d2 <= vv) {                              // inclusive, as ref.py
          kept += sq;
        } else {
          tmass += wi;
          tcost += sq;
        }
      }
      kept = block_sum(kept);
      tmass = block_sum(tmass);
      tcost = block_sum(tcost);
      if (threadIdx.x == 0) {
        float* o = part + j * 3 * tiles + (tile - j * tiles);
        o[0] = kept;
        o[tiles] = tmass;
        o[2 * tiles] = tcost;
      }
    }
    if (DR == 0 && staged_rows) {
      __syncthreads();                         // the walk read the stage
      if (threadIdx.x == 0) stage_item(it + gridDim.x);
    }
  }
}

}  // namespace rt

// x is (m, p, d), w (m, p); out holds (m, 3): each machine's kept cost,
// tail mass and tail cost. ppt is the points a thread and slices the
// center slices (kernels/truncated.py::launch_shape: walk.py's rules over
// the m·tiles tiles of the launch; ppt must be the walk's own P for the
// width); sms is the card's SMs. scratch holds scratch_bytes bytes laid
// out as rt::trunc_scratch says.
extern "C" int rt_truncated_cost(const void* x, int dtype, int m,
                                 long long p, int d, const float* w,
                                 const float* c, const uint8_t* cv, int k,
                                 const float* v, int ppt, int slices,
                                 int sms, void* scratch,
                                 long long scratch_bytes, float* out,
                                 void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  if (m < 0 || p < 0 || slices < 1) return (int)cudaErrorInvalidValue;
  const long long tiles = point_tiles(p, ppt);
  const TruncScratch sc = trunc_scratch(m, p, tiles, slices);
  if ((long long)sc.total > scratch_bytes) return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  unsigned char* base = (unsigned char*)scratch;
  float* part = (float*)(base + sc.part);
  if (p > 0) {
    unsigned* done = nullptr;
    float* ws_best = nullptr;
    if (slices > 1) {
      done = (unsigned*)(base + sc.done);
      ws_best = (float*)(base + sc.best);
      const cudaError_t e =
          cudaMemsetAsync(done, 0, (size_t)m * tiles * 4, s);
      if (e != cudaSuccess) return (int)e;
    }
    const cudaError_t e =
        dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
          using T = std::remove_pointer_t<decltype(tag)>;
          constexpr int DR = decltype(dr)::value;
          constexpr int P = DR > 0 ? 4 : 2;  // rows in registers, or re-read
          if (ppt != P) return cudaErrorInvalidValue;  // the wrapper's tiles
          const int slice = (k + slices - 1) / slices;
          const TileShape ts = tile_shape(d, DR, slice);
          const long long tile_bytes =
              (long long)kThreads * P * d * sizeof(T);
          const int sbytes =
              tile_bytes <= kStageMax
                  ? stage_bytes(kThreads * P, d, (int)sizeof(T))
                  : 0;
          const size_t smem = (size_t)sbytes + ts.smem;
          const long long items = (long long)m * tiles * slices;
          auto kern = truncated_kernel<T, DR, P>;
          int per_sm = 0;
          const cudaError_t e1 = blocks_per_sm(kern, smem, &per_sm);
          if (e1 != cudaSuccess) return e1;
          const long long wave = (long long)per_sm * sms;
          return launch(kern, dim3((unsigned)(wave < items ? wave : items)),
                        smem, s, (const T*)x, p, d, w, c, cv, k, ts.kt, slice,
                        slices, tiles, items, sbytes, v, done, ws_best, part);
        });
    if (e != cudaSuccess) return (int)e;
  }
  return (int)reduce_rows(part, p > 0 ? tiles : 0, 3LL * m, out, s);
}
