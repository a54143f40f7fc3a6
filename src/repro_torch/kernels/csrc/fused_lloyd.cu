// One-sweep fused clustering kernels: remove_below and the D² seeding
// step (update_min_dist, and with it the whole k-means++ seeding). Each
// reads the points once and keeps the (n,) distances out of device memory
// where the reference does (repro/kernels/fused_lloyd.py). The Lloyd step
// of the same TPU file, fused_assign_reduce, is fused_assign.cu.
//
// Blocks run in parallel and in no order on the card, so nothing is
// accumulated across blocks the way the Pallas kernels accumulate across
// grid steps under @pl.when(i == 0). Float sums across blocks go through
// per-block partials and a second, fixed-order pass (reduce_rows_kernel):
// no float atomics, so every call gives the same bits on every run. The
// only atomics are the integer survivor counts of remove_below and the
// seeding draw's 64-bit atomicMax, both exact in any order.
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
// need; at kimi-k2's embedding table (8 × 20,480 × 78 centers × 7,168)
// by the same operations, 2.73 ms. Design: min_dist's walks over a grid
// of (point tile, machine): at d <= 16 the register-blocked walk
// (common.cuh: nearest_split, one slice: the 10 M points fill the card in
// every cell), 4 points a thread; past 16 the tiled walk (common.cuh:
// tiled_nearest), 128 points a block against 80 centers at a time, both
// staged through shared memory (the register-blocked walk re-read each
// row for every center there: 0.6% of the bound at d = 7,168, PERF.md
// §6). The threshold v is read through a device pointer, so the host
// never waits for it; each block counts its survivors
// (__syncthreads_count) and adds them to its machine's int32 count with
// one atomicAdd. The (m, p) distance array never exists. Each point's d2
// is min_dist's to the bit, so the mask is exactly alive & (min_dist's
// d2 > v). Blocks an SM: 2 on both walks (ptxas: 110 registers at P = 4;
// the tiled walk's 40 accumulators).
template <typename T, int DR, int P>
__global__ void __launch_bounds__(kThreads, 2)
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

// d > 16: machine blockIdx.y's rows x[base .. base + p) on the tiled walk,
// a block a tile of kTilePoints; lane tx = i of point group ty owns point
// ty + kTiledRows·i, so a thread decides at most one point.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    tiled_remove_below_kernel(const T* __restrict__ x, long long p, int d,
                              const float* __restrict__ c,
                              const uint8_t* __restrict__ cv, int k,
                              bool xvec, bool cvec,
                              const float* __restrict__ v,
                              const uint8_t* __restrict__ alive,
                              uint8_t* __restrict__ alive_new,
                              int* __restrict__ live) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  TiledSmem& sm = *reinterpret_cast<TiledSmem*>(smem_raw);
  const long long base = (long long)blockIdx.y * p;
  const long long p0 = (long long)blockIdx.x * kTilePoints;
  float best[kTiledPPT];
  int arg[kTiledPPT];
  tiled_nearest<T>(x + base * d, p, d, c, cv, k, p0, xvec, cvec, sm, best,
                   arg);
  const float vv = *v;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int keep = 0;
#pragma unroll
  for (int i = 0; i < kTiledPPT; ++i) {
    const int r = ty + kTiledRows * i;         // the point in the tile
    if (tx == i && p0 + r < p) {
      const long long row = base + p0 + r;
      keep = alive[row] && clamp0(best[i] + sm.x2[r]) > vv;   // strict >
      alive_new[row] = (uint8_t)keep;
    }
  }
  const int n_keep = __syncthreads_count(keep);
  if (threadIdx.x == 0 && n_keep) atomicAdd(live + blockIdx.y, n_keep);
}


// ------------------------------------------------------- D² seeding step
// Replaces repro/kernels/fused_lloyd.py::update_min_dist_pallas
// (pallas_call at fused_lloyd.py:370) and its big-n twin
// update_min_dist_pipelined_pallas (fused_lloyd.py:467), and with them the
// categorical draw that repro/core/kmeans.py:28-31 and :56-58 make after
// each call (XLA fuses it into the lax.scan step there).
//
// Two modes, on each width's kernel (the design by width is below):
//  * draw off (rt_update_min_dist, ops.update_min_dist): d2_new =
//    min(d2, d2 to k centers) and one partial of sum w·d2_new a tile
//    (not a block), added up by the fixed-order reduce_rows pass, so the
//    sum's bits do not depend on the grid. An invalid center's
//    ||c||^2 is +inf, so with no valid center no candidate is < d2 and d2
//    passes through bit for bit.
//  * draw on (rt_kmeanspp): one k-means++ step. Step i reads step i-1's
//    winner from device memory, takes that row of x, widened to float32,
//    as the new center, and lowers each point's d2 IN PLACE (each thread
//    owns its points; no other thread reads or writes them). It then draws
//    the next center by Gumbel-max, with two keys a point from one uniform
//    u_i and g_i = -log(-log u_i):
//        log(max(w_i·d2_i, 1e-38)) + g_i   and   log(max(w_i, 1e-38)) + g_i,
//    each -inf where its weight term is not > 0 (core/sampling.py::
//    gumbel_argmax's formula). Each block keeps the maximum of each key
//    over its tiles, the lowest index winning a tie as in torch.argmax,
//    and publishes it with one 64-bit atomicMax: the key's
//    order-preserving bits above 0xFFFFFFFF - index. atomicMax gives the
//    same word in any order, so the draw is deterministic with no
//    last-block pass. The winner is the D² word if its key is above -inf,
//    else the w word. For sums of non-negative terms that is exactly the
//    reference's mass > 0 test (repro/core/kmeans.py:56-57), so the step
//    needs no mass and no second launch. Step 0 has no center and draws
//    on the w key alone (kmeans.py:48).
//
// Per point the arithmetic is common.cuh's: the same fmaf chains for
// ||x||^2 and x.c over ascending q, ||c||^2 by load_centers' chain (the
// tiled walk's past 16 centers), t = fmaf(-2, x.c, ||c||^2),
// clamp0(t + ||x||^2) and a strict <. So both modes give the same d2 for
// the same center, bit for bit, and it is min_dist's d2 for a one-center
// block.
//
// Random bits: Philox4x32-10, written out below (no cuRAND). The key is a
// 64-bit seed that the wrapper draws once a seeding from the caller's
// torch.Generator, as a (2,) device tensor read through a pointer (never
// by the host); the counter is (point index, step, 0, 0); word 0 gives
// u = (2·(r >> 9) + 1)·2^-24, exact in float32 and never 0 or 1. The
// counter does not depend on the launch shape, so the plain version
// (kernels/ref.py) draws the same bits. A step over a part of the set (a
// mesh rank's rows, rt_kmeanspp_step_at) keys its counters and its words'
// indices on the global index base + i, and takes its center as d floats
// (the winning row, gathered from the rank that holds it): the largest
// word over the parts is then the whole set's, bit for bit.
//
// Bound: bytes. A step reads x, w and d2 and writes d2 for 2·d FMAs and
// one Philox block a point, far below the card's rates: at SOCCER
// k = 1000's coordinator (991,418 x 15, float32) 71.4 MB, 21.3 us at
// 3.35 TB/s; at kimi-k2's table fit (43,106 x 7,168) 1.24 GB, 0.369 ms.
// Each step after the first is a programmatic dependent launch of the one
// before: its blocks start as the step before's leave the SMs and put
// their first rows in flight before they wait for it, so the launch gap
// and the first load overlap the step before's tail. That early read is
// safe because no step writes x or w; the first step of a C call waits for
// everything before it (an ordinary launch), so x and w are whatever the
// stream wrote before the call. The w keys are computed only where they
// can be read (step 0, and a block with no D² key above -inf). One C call
// (rt_kmeanspp) launches the k steps of a seeding back to back, then one
// small kernel that writes the k chosen indices, so the host does nothing
// a step and reads nothing back. Design, by width:
//  * d <= 16 (seed_step_kernel, the rows in registers): one wave of blocks
//    (the occupancy query's blocks an SM times the SMs), each walking a
//    grid-stride loop over tiles of 256 contiguous rows, staged into
//    shared memory by TMA bulk copies (one thread issues a tile's rows, w
//    and d2 against the stage's mbarrier; common.cuh's helpers, shared
//    with truncated_cost) and double-buffered: tile t + grid is in flight
//    while tile t is computed.
//  * d > 16 (tiled_seed_kernel): a block a tile of the tiled walk's 128
//    points, a thread a point (threads 0-127; thread 128 carries the
//    center's ||c||^2 chain). The tile's rows and the center's matching
//    coordinates stream through a ring of kSeedStages stages of 32
//    coordinates (common.cuh: stage_rows; cp.async for float32, 2-byte
//    rows widened through registers), kSeedStages - 1 of them in flight
//    while one is walked, so neither a row nor the center is ever held
//    whole in shared memory. A thread reads its row from its stage as
//    float4s at a pitch of 36 floats (no bank conflict). The draw-off
//    call against more than one center (tiled_update_kernel) takes
//    tiled_nearest and the same epilogue. One tile a block: 337 blocks at
//    the table fit's 43,106 rows, all resident at 3 blocks an SM. On the
//    H100 at 43,106 x 7,168 (PERF.md §6) this runs at 80% of the byte
//    bound; 256-point tiles (169 blocks) ran 11% slower, and 2 or 4
//    stages within 0.5% of 3.

constexpr uint32_t kNegInfKey = 0x007FFFFFu;   // key_word's bits of -inf
constexpr int kSeedStages = 3;   // point stages a block at d > 16

// Rows of a tile: kThreads on the register rows, the tiled walk's
// kTilePoints past them (kernels/fused_lloyd.py::seed_tiles mirrors it).
__host__ __device__ inline int seed_tile_rows(int d) {
  return d <= 16 ? kThreads : kTilePoints;
}

// Philox4x32-10 (Salmon et al., SC'11; Random123's round and key
// schedule): word 0 of the block at counter (c0, c1, 0, 0), key (k0, k1).
__device__ __forceinline__ uint32_t philox_word0(uint32_t c0, uint32_t c1,
                                                 uint32_t k0, uint32_t k1) {
  uint32_t x0 = c0, x1 = c1, x2 = 0u, x3 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, x0), lo0 = 0xD2511F53u * x0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, x2), lo1 = 0xCD9E8D57u * x2;
    x0 = hi1 ^ x1 ^ k0;
    x1 = lo1;
    x2 = hi0 ^ x3 ^ k1;
    x3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return x0;
}

// g = -log(-log u), u = (2·(r >> 9) + 1)·2^-24.
__device__ __forceinline__ float gumbel(uint32_t r) {
  const float u = (float)(2u * (r >> 9) + 1u) * 0x1p-24f;
  return -logf(-logf(u));
}

// A Gumbel-max key: log(max(p, 1e-38)) + g where p > 0, else -inf.
__device__ __forceinline__ float gumbel_key(float p, float g) {
  return p > 0.f ? logf(fmaxf(p, 1e-38f)) + g : -INFINITY;
}

// The key's order-preserving bits over 0xFFFFFFFF - i: a larger word is a
// larger key, or the same key at a lower index. -0 is taken as +0, the
// tie torch.argmax sees.
__device__ __forceinline__ unsigned long long key_word(float key,
                                                       long long i) {
  const uint32_t b = __float_as_uint(key == 0.f ? 0.f : key);
  const uint32_t o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)o << 32) | (0xFFFFFFFFu - (uint32_t)i);
}

// The step's winner: the D² word's index if its key is above -inf, else
// the w word's.
__device__ __forceinline__ long long winner_of(unsigned long long wd,
                                               unsigned long long ww) {
  const unsigned long long word =
      (uint32_t)(wd >> 32) > kNegInfKey ? wd : ww;
  return (long long)(0xFFFFFFFFu - (uint32_t)word);
}

// Block maximum of v, valid in thread 0 (thread 0 then holds it).
__device__ __forceinline__ unsigned long long block_max(
    unsigned long long v) {
  __shared__ unsigned long long warp_max[32];
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u > v ? u : v;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                             // warp_max free for reuse
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = (warp == 0 && lane < nwarps) ? warp_max[lane] : 0ull;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
      v = u > v ? u : v;
    }
  }
  return v;
}

// The centers [t0, t0 + rows) into the shared tile, laid out as
// common.cuh's load_center_tile lays it out (rows DR floats apart,
// zero-padded past d, then kt
// ||c||^2, +inf for an invalid center). Draw on, the one center is row
// `win` of x, widened; draw off, rows of the float32 centers c. Every
// thread of the block must call this.
template <typename T, int DR, bool kDraw>
__device__ __forceinline__ void load_centers(
    const T* __restrict__ x, long long win, const float* __restrict__ c,
    const uint8_t* __restrict__ cv, int d, int t0, int rows, int kt,
    float* sc) {
  constexpr int stride = DR;
  float* sc2 = sc + (size_t)kt * stride;
  __syncthreads();                             // last tile fully consumed
  for (int e = threadIdx.x; e < rows * stride; e += blockDim.x) {
    const int j = e / stride;
    const int q = e - j * stride;
    float v = 0.f;
    if (q < d) {
      if constexpr (kDraw) {
        v = c != nullptr ? c[q] : widen(x[win * d + q]);
      } else {
        v = c[(size_t)(t0 + j) * d + q];
      }
    }
    sc[e] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < d; ++q) {
      const float v = sc[(size_t)j * stride + q];
      s = fmaf(v, v, s);
    }
    sc2[j] = (kDraw || cv == nullptr || cv[t0 + j]) ? s : INFINITY;
  }
  __syncthreads();
}

// best = min(best, t) over the `rows` centers of the shared tile, for
// the one point of r (its row in registers): the per-point arithmetic of
// common.cuh with no argmin.
template <typename T, int DR>
__device__ __forceinline__ void seed_walk(const Rows<T, DR, 1>& r,
                                          const float* sc, const float* sc2,
                                          int rows, float& best) {
  static_assert(DR > 0, "past the register rows: tiled_seed_kernel");
  for (int j = 0; j < rows; ++j) {
    float dot = 0.f;
    const float4* cr = reinterpret_cast<const float4*>(sc + (size_t)j * DR);
#pragma unroll
    for (int q = 0; q < DR / 4; ++q) {
      const float4 v = cr[q];
      dot = fmaf(r.xr[0][4 * q], v.x, dot);
      dot = fmaf(r.xr[0][4 * q + 1], v.y, dot);
      dot = fmaf(r.xr[0][4 * q + 2], v.z, dot);
      dot = fmaf(r.xr[0][4 * q + 3], v.w, dot);
    }
    const float t = fmaf(-2.f, dot, sc2[j]);
    if (t < best) best = t;
  }
}

// Tile t's parts, each a range of bytes: its rows, its w, its d2.
template <typename T>
struct TileParts {
  const unsigned char* src[3];
  long long len[3];

  __device__ __forceinline__ TileParts(const T* x, const float* w,
                                       const float* d2, long long n, int d,
                                       int tile_rows, long long t) {
    const long long r0 = t * tile_rows;
    const long long rows = min((long long)tile_rows, n - r0);
    src[0] = reinterpret_cast<const unsigned char*>(x + r0 * d);
    len[0] = rows * d * (long long)sizeof(T);
    src[1] = reinterpret_cast<const unsigned char*>(w + r0);
    src[2] = reinterpret_cast<const unsigned char*>(d2 + r0);
    len[1] = len[2] = rows * 4;
  }

  // The bytes the parts in `on` bring (bit q: part q).
  __device__ __forceinline__ unsigned bytes(unsigned on) const {
    unsigned b = 0;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (on >> q & 1u) b += aligned_len(src[q], len[q]);
    }
    return b;
  }

  // Copies the parts in `on` to buf, buf + rbytes and buf + rbytes +
  // vbytes, completing on bar. One thread calls it.
  __device__ __forceinline__ void stage(unsigned on, unsigned char* buf,
                                        int rbytes, int vbytes,
                                        unsigned long long* bar) const {
    unsigned char* dst[3] = {buf, buf + rbytes, buf + rbytes + vbytes};
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (on >> q & 1u) bulk_copy(dst[q], src[q], len[q], bar);
    }
  }
};

// One seeding step over n points in tiles of tile_rows rows. A stage
// buffer (sbytes long) holds a tile's rows, then its w and its d2; after
// the two stages comes the center tile (kt rows). Draw off: k centers c
// (cv), d2_out = min(d2_in, ...) and part[block] = the block's sum of
// w·d2_out in tile t's part[t]. Draw on: d2_in == d2_out (updated in place); the center is
// the winner of (prev_d2, prev_w), none when they are NULL (step 0); the
// step's words go to win_d2 and win_w (zeroed by the caller).
//
// Draw on, the w keys are computed only where they can be read: at step
// 0, and in a block none of whose points has w·d2 > 0 (then, in a second
// pass over the block's points). A block that holds a D² key above -inf
// publishes no w word: the w word is read only when no D² key is above
// -inf, and then every block publishes its own.
template <typename T, int DR, bool kDraw>
__global__ void __launch_bounds__(kThreads)
    seed_step_kernel(const T* __restrict__ x, long long n, int d,
                     int tile_rows, int sbytes, const float* __restrict__ w,
                     const float* d2_in, float* d2_out,
                     const float* __restrict__ c,
                     const uint8_t* __restrict__ cv, int k, int kt,
                     float* __restrict__ part,
                     const unsigned long long* prev_d2,
                     const unsigned long long* prev_w,
                     unsigned long long* win_d2, unsigned long long* win_w,
                     const long long* __restrict__ seed, int step,
                     long long base) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  unsigned char* stage[2] = {smem_u8, smem_u8 + sbytes};
  float* sc = reinterpret_cast<float*>(smem_u8 + 2 * (size_t)sbytes);
  const float* sc2 = sc + (size_t)kt * DR;

  int kc = k;                                  // centers this step walks
  if constexpr (kDraw) kc = (prev_w != nullptr || c != nullptr) ? 1 : 0;
  const bool resident = kc <= kt;
  const bool read_d2 = kc > 0 || !kDraw;       // step 0 leaves d2 alone
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  const int rbytes = stage_bytes(tile_rows, d, (int)sizeof(T));
  const int vbytes = stage_bytes(tile_rows, 1, 4);
  // the parts a tile stages: rows (with a center), w, d2 (bits 0, 1, 2)
  const unsigned parts = (kc > 0 ? 1u : 0u) | 2u | (read_d2 ? 4u : 0u);

  __shared__ __align__(8) unsigned long long full[2];   // stage b landed
  if (threadIdx.x == 0) {
    barrier_init(&full[0]);
    barrier_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned phase = 0u;                         // bit b: stage b's parity

  // The first tile's rows and w (no step writes them) are in flight
  // before the wait for the step before, its d2 after it, all under the
  // center's load. The grid has at most one block a tile.
  const TileParts<T> first(x, w, d2_in, n, d, tile_rows, blockIdx.x);
  if (threadIdx.x == 0) {
    barrier_expect(&full[0], first.bytes(parts));
    first.stage(parts & 3u, stage[0], rbytes, vbytes, &full[0]);
  }
  long long win = 0;
  uint32_t k0 = 0u, k1 = 0u;
  if constexpr (kDraw) {
    launch_dependents();
    wait_prerequisites();
    if (prev_w != nullptr) win = winner_of(__ldcg(prev_d2), __ldcg(prev_w));
    k0 = (uint32_t)seed[0];
    k1 = (uint32_t)seed[1];
  }
  if (threadIdx.x == 0) {
    first.stage(parts & 4u, stage[0], rbytes, vbytes, &full[0]);
  }
  if (kc > 0 && resident) {
    load_centers<T, DR, kDraw>(x, win, c, cv, d, 0, kc, kt, sc);
  }

  unsigned long long best_d = 0ull, best_w = 0ull;
  int b = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    if (threadIdx.x == 0 && t + gridDim.x < tiles) {
      const TileParts<T> next(x, w, d2_in, n, d, tile_rows, t + gridDim.x);
      barrier_expect(&full[b ^ 1], next.bytes(parts));
      next.stage(parts, stage[b ^ 1], rbytes, vbytes, &full[b ^ 1]);
    }
    barrier_wait(&full[b], phase >> b & 1u);   // tile t staged
    phase ^= 1u << b;
    const long long r0 = t * tile_rows;
    const int rows = (int)min((long long)tile_rows, n - r0);
    const long long i = r0 + threadIdx.x;
    const bool active = (int)threadIdx.x < rows;
    const float* sw = staged<float>(stage[b] + rbytes, w + r0);
    const float* sd = staged<float>(stage[b] + rbytes + vbytes, d2_in + r0);
    float nd = 0.f;
    if (active && read_d2) nd = sd[threadIdx.x];
    if (kc > 0) {
      const Rows<T, DR, 1> r(staged<T>(stage[b], x + r0 * d), r0, r0 + rows,
                             d, i);
      float best = INFINITY;
      if (resident) {
        if (active) seed_walk(r, sc, sc2, kc, best);
      } else {
        for (int t0 = 0; t0 < kc; t0 += kt) {
          const int rows_c = min(kt, kc - t0);
          load_centers<T, DR, kDraw>(x, win, c, cv, d, t0, rows_c, kt, sc);
          if (active) seed_walk(r, sc, sc2, rows_c, best);
        }
      }
      if (active) {
        const float cand = clamp0(best + r.x2[0]);
        nd = cand < nd ? cand : nd;
      }
    }
    if constexpr (kDraw) {
      if (active) {
        if (kc > 0) d2_out[i] = nd;            // in place: this thread's
        const long long gi = base + i;         // the point's global index
        const float g =
            gumbel(philox_word0((uint32_t)gi, (uint32_t)step, k0, k1));
        const float wi = sw[threadIdx.x];
        if (kc > 0) {
          const unsigned long long kd = key_word(gumbel_key(wi * nd, g), gi);
          best_d = kd > best_d ? kd : best_d;
        } else {
          const unsigned long long kw = key_word(gumbel_key(wi, g), gi);
          best_w = kw > best_w ? kw : best_w;
        }
      }
    } else {
      float contrib = 0.f;
      if (active) {
        d2_out[i] = nd;
        contrib = sw[threadIdx.x] * nd;
      }
      const float s = block_sum(contrib);
      if (threadIdx.x == 0) part[t] = s;
    }
    __syncthreads();                           // stage[b] read by all
    b ^= 1;
  }
  if constexpr (kDraw) {
    __shared__ int fallback;
    best_d = block_max(best_d);
    if (threadIdx.x == 0) fallback = (uint32_t)(best_d >> 32) <= kNegInfKey;
    __syncthreads();
    if (kc > 0 && fallback) {
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long i = t * tile_rows + threadIdx.x;
        if ((int)threadIdx.x < tile_rows && i < n) {
          const float g = gumbel(
              philox_word0((uint32_t)(base + i), (uint32_t)step, k0, k1));
          const unsigned long long kw =
              key_word(gumbel_key(w[i], g), base + i);
          best_w = kw > best_w ? kw : best_w;
        }
      }
    }
    best_w = block_max(best_w);
    if (threadIdx.x == 0) {
      if (best_d) atomicMax(win_d2, best_d);
      if (fallback && best_w) atomicMax(win_w, best_w);
    }
  }
}

// ------------------------------------------------ the step past d = 16
// The stages of tiled_seed_kernel: kSeedStages of the point tile's rows,
// each beside the center's matching coordinates, and ||c||^2.
struct SeedSmem {
  float xs[kSeedStages][kTilePoints * kTilePitch];
  float cs[kSeedStages][kTilePitch];
  float c2;
};
static_assert(kTilePoints < kThreads && kSeedStages >= 2,
              "a thread past the points carries ||c||^2");

// One seeding step at d > 16 against one center (draw off: row 0 of c,
// cv; draw on: row `win` of x widened, or `center`, or none at step 0),
// a block a tile of kTilePoints points, thread i < kTilePoints owning
// point p0 + i: the arguments and outputs of seed_step_kernel's modes
// (part[tile] the tile's sum of w·d2_out, draw off; the step's words into
// win_d2 and win_w, draw on, d2 updated in place).
template <typename T, bool kDraw>
__global__ void __launch_bounds__(kThreads, 3)
    tiled_seed_kernel(const T* __restrict__ x, long long n, int d,
                      bool xvec, const float* __restrict__ w,
                      const float* d2_in,
                      float* d2_out, const float* __restrict__ c,
                      const uint8_t* __restrict__ cv,
                      float* __restrict__ part,
                      const unsigned long long* prev_d2,
                      const unsigned long long* prev_w,
                      unsigned long long* win_d2, unsigned long long* win_w,
                      const long long* __restrict__ seed, int step,
                      long long base) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  SeedSmem& sm = *reinterpret_cast<SeedSmem*>(smem_raw);
  const int tid = threadIdx.x;
  const long long p0 = (long long)blockIdx.x * kTilePoints;
  const long long i = p0 + tid;
  const bool active = tid < kTilePoints && i < n;
  const bool centered = !kDraw || prev_w != nullptr || c != nullptr;
  const int nq = centered ? (d + kTileDepth - 1) / kTileDepth : 0;

  // The first point stages are in flight before the wait for the step
  // before (no step writes x), the center's after it; one copy group a
  // stage from here on.
#pragma unroll
  for (int s = 0; s + 1 < kSeedStages; ++s) {
    if (s < nq) {
      stage_rows<T, kTilePoints>(x, n, d, p0, s * kTileDepth, xvec,
                                 sm.xs[s]);
    }
    cp_async_commit();
  }
  long long win = 0;
  uint32_t k0 = 0u, k1 = 0u;
  if constexpr (kDraw) {
    launch_dependents();
    wait_prerequisites();
    if (prev_w != nullptr) win = winner_of(__ldcg(prev_d2), __ldcg(prev_w));
    k0 = (uint32_t)seed[0];
    k1 = (uint32_t)seed[1];
  }
  auto stage_center = [&](int s, int q0) {
    if constexpr (kDraw) {
      if (c == nullptr) {
        stage_rows<T, 1>(x + win * d, 1, d, 0, q0, false, sm.cs[s]);
        return;
      }
    }
    stage_rows<float, 1>(c, 1, d, 0, q0, false, sm.cs[s]);
  };
  for (int s = 0; s + 1 < kSeedStages && s < nq; ++s) {
    stage_center(s, s * kTileDepth);
  }
  const float wi = active ? w[i] : 0.f;
  float nd = (active && centered) ? d2_in[i] : 0.f;   // step 0: d2 alone

  // thread i < kTilePoints: its point's ||x||^2 and x.c; thread
  // kTilePoints: ||c||^2; each an fmaf chain over ascending q (the zeros
  // past d add nothing a sign of zero can show)
  float x2 = 0.f, dot = 0.f, c2 = 0.f;
  for (int it = 0; it < nq; ++it) {
    if (it == 0) {
      cp_async_wait_all();
    } else {
      cp_async_wait_group<kSeedStages - 2>();
    }
    __syncthreads();           // stage it landed, stage it - 1 walked
    const int next = it + kSeedStages - 1;
    if (next < nq) {
      const int sn = next % kSeedStages;
      stage_rows<T, kTilePoints>(x, n, d, p0, next * kTileDepth, xvec,
                                 sm.xs[sn]);
      stage_center(sn, next * kTileDepth);
    }
    cp_async_commit();
    const int s = it % kSeedStages;
    const float4* cr = reinterpret_cast<const float4*>(sm.cs[s]);
    if (tid < kTilePoints) {
      const float4* xr =
          reinterpret_cast<const float4*>(sm.xs[s] + tid * kTilePitch);
#pragma unroll
      for (int q4 = 0; q4 < kTileDepth / 4; ++q4) {
        const float4 a = xr[q4];
        const float4 b = cr[q4];
        x2 = fmaf(a.x, a.x, x2);
        dot = fmaf(a.x, b.x, dot);
        x2 = fmaf(a.y, a.y, x2);
        dot = fmaf(a.y, b.y, dot);
        x2 = fmaf(a.z, a.z, x2);
        dot = fmaf(a.z, b.z, dot);
        x2 = fmaf(a.w, a.w, x2);
        dot = fmaf(a.w, b.w, dot);
      }
    } else if (tid == kTilePoints) {
#pragma unroll
      for (int q4 = 0; q4 < kTileDepth / 4; ++q4) {
        const float4 b = cr[q4];
        c2 = fmaf(b.x, b.x, c2);
        c2 = fmaf(b.y, b.y, c2);
        c2 = fmaf(b.z, b.z, c2);
        c2 = fmaf(b.w, b.w, c2);
      }
      if (it == nq - 1) {
        sm.c2 = (kDraw || cv == nullptr || cv[0]) ? c2 : INFINITY;
      }
    }
  }
  if (nq > 0) {
    __syncthreads();                           // sm.c2 written
    if (active) {
      float best = INFINITY;
      const float t = fmaf(-2.f, dot, sm.c2);
      if (t < best) best = t;
      const float cand = clamp0(best + x2);
      nd = cand < nd ? cand : nd;
    }
  }
  if constexpr (kDraw) {
    unsigned long long best_d = 0ull, best_w = 0ull;
    float g = 0.f;
    if (active) {
      if (centered) d2_out[i] = nd;            // in place: this thread's
      const long long gi = base + i;           // the point's global index
      g = gumbel(philox_word0((uint32_t)gi, (uint32_t)step, k0, k1));
      if (centered) {
        best_d = key_word(gumbel_key(wi * nd, g), gi);
      } else {
        best_w = key_word(gumbel_key(wi, g), gi);
      }
    }
    __shared__ int fallback;
    best_d = block_max(best_d);
    if (tid == 0) fallback = (uint32_t)(best_d >> 32) <= kNegInfKey;
    __syncthreads();
    if (centered && fallback && active) {
      best_w = key_word(gumbel_key(wi, g), base + i);
    }
    best_w = block_max(best_w);
    if (tid == 0) {
      if (best_d) atomicMax(win_d2, best_d);
      if (fallback && best_w) atomicMax(win_w, best_w);
    }
  } else {
    float contrib = 0.f;
    if (active) {
      d2_out[i] = nd;
      contrib = wi * nd;
    }
    const float sum = block_sum(contrib);
    if (tid == 0) part[blockIdx.x] = sum;
  }
}

// The draw-off step at d > 16 against k != 1 centers: tiled_nearest over
// the block's tile, then tiled_seed_kernel's epilogue, each point's w·d2
// summed in the same thread order (through sm.part), so the partials
// take the same bits as the one-center kernel's for the same d2.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    tiled_update_kernel(const T* __restrict__ x, long long n, int d,
                        const float* __restrict__ c,
                        const uint8_t* __restrict__ cv, int k, bool xvec,
                        bool cvec, const float* __restrict__ w,
                        const float* __restrict__ d2_in,
                        float* __restrict__ d2_out,
                        float* __restrict__ part) {
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
      float contrib = 0.f;
      if (p0 + r < n) {
        const float cand = clamp0(best[i] + sm.x2[r]);
        const float nd0 = d2_in[p0 + r];
        const float nd = cand < nd0 ? cand : nd0;
        d2_out[p0 + r] = nd;
        contrib = w[p0 + r] * nd;
      }
      sm.part[r] = contrib;
    }
  }
  __syncthreads();
  const float sum = block_sum(
      (int)threadIdx.x < kTilePoints ? sm.part[threadIdx.x] : 0.f);
  if (threadIdx.x == 0) part[blockIdx.x] = sum;
}

// idx[i] = the winner of step i, for i < k.
__global__ void __launch_bounds__(kThreads)
    seed_indices_kernel(const unsigned long long* __restrict__ win_d2,
                        const unsigned long long* __restrict__ win_w, int k,
                        long long* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < k) idx[i] = winner_of(win_d2[i], win_w[i]);
}

// Launch shape of a seeding step on the register rows (d <= 16): rows a
// tile, bytes a stage (the rows, w and d2), dynamic shared memory (two
// stages and a center tile of kt rows) and tiles.
struct SeedShape {
  int tile_rows;
  int sbytes;
  size_t smem;
  long long tiles;
};

inline SeedShape seed_shape(long long n, int d, int itemsize, int kt,
                            int stride) {
  SeedShape s;
  s.tile_rows = seed_tile_rows(d);
  s.sbytes = stage_bytes(s.tile_rows, d, itemsize) +
             2 * stage_bytes(s.tile_rows, 1, 4);
  s.smem = 2 * (size_t)s.sbytes + ((size_t)kt * stride + kt) * sizeof(float);
  s.tiles = (n + s.tile_rows - 1) / s.tile_rows;
  return s;
}

// One wave of a seed_step_kernel instance's blocks at `smem` bytes of
// shared memory, at most `tiles` (common.cuh: blocks_per_sm).
template <typename K>
inline cudaError_t one_wave(K kern, size_t smem, int sms, long long tiles,
                            long long* grid) {
  int per_sm = 0;
  const cudaError_t e = blocks_per_sm(kern, smem, &per_sm);
  if (e != cudaSuccess) return e;
  const long long g = (long long)per_sm * sms;
  *grid = g < tiles ? g : tiles;
  return cudaSuccess;
}

// `count` draw-on steps from step `first` over rows base .. base + n - 1
// of the seeded set: the first reads its center's words from (prev_d2,
// prev_w), or takes `center` (d floats), or has none (all NULL), each
// later one reads the step before it; step first + i writes win_d2[i] and win_w[i]. The first
// is an ordinary launch, each later one a programmatic dependent.
inline cudaError_t seed_steps(const void* x, int dtype, long long n, int d,
                              const float* w, const long long* seed,
                              float* d2, int first, int count,
                              const unsigned long long* prev_d2,
                              const unsigned long long* prev_w,
                              const float* center, long long base,
                              unsigned long long* win_d2,
                              unsigned long long* win_w, int sms,
                              cudaStream_t s) {
  if (n <= 0 || n >= (1ll << 31)) return cudaErrorInvalidValue;
  return dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    const T* xt = (const T*)x;
    const uint8_t* none_u8 = nullptr;
    float* no_part = nullptr;
    if constexpr (DR == 0) {
      const dim3 grid((unsigned)((n + kTilePoints - 1) / kTilePoints));
      for (int i = 0; i < count; ++i) {
        const cudaError_t e = launch_ex(
            i > 0, tiled_seed_kernel<T, true>, grid, sizeof(SeedSmem), s,
            xt, n, d, copies16<T>(x, d), w, (const float*)d2, d2,
            i ? nullptr : center,
            none_u8, no_part, i ? win_d2 + i - 1 : prev_d2,
            i ? win_w + i - 1 : prev_w, win_d2 + i, win_w + i, seed,
            first + i, base);
        if (e != cudaSuccess) return e;
      }
      return cudaSuccess;
    } else {
      const SeedShape ss = seed_shape(n, d, (int)sizeof(T), 1, DR);
      auto kern = seed_step_kernel<T, DR, true>;
      long long grid = 0;
      cudaError_t e = one_wave(kern, ss.smem, sms, ss.tiles, &grid);
      if (e != cudaSuccess) return e;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
      attr[0].val.programmaticStreamSerializationAllowed = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((unsigned)grid);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = ss.smem;
      cfg.stream = s;
      cfg.attrs = attr;
      const float* none_f = nullptr;
      for (int i = 0; i < count; ++i) {
        cfg.numAttrs = i ? 1 : 0;                // the first waits for all
        const unsigned long long* pd = i ? win_d2 + i - 1 : prev_d2;
        const unsigned long long* pw = i ? win_w + i - 1 : prev_w;
        const float* ci = i ? none_f : center;
        e = cudaLaunchKernelEx(&cfg, kern, xt, n, d, ss.tile_rows, ss.sbytes,
                               w, (const float*)d2, d2, ci, none_u8, 1, 1,
                               no_part, pd, pw, win_d2 + i, win_w + i, seed,
                               first + i, base);
        if (e != cudaSuccess) return e;
      }
      return cudaSuccess;
    }
  });
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
    if (m == 0 || p == 0) return cudaGetLastError();
    if constexpr (DR == 0) {                   // the tiled walk
      return launch(tiled_remove_below_kernel<T>,
                    dim3((unsigned)tiled_tiles(p), (unsigned)m),
                    sizeof(TiledSmem), s, (const T*)x, p, d, c, cv, k,
                    copies16<T>(x, d), copies16<float>(c, d), v, alive,
                    alive_new, live);
    } else {
      constexpr int P = 4;                     // min_dist's points a thread
      const TileShape ts = tile_shape(DR, k);
      const dim3 grid((unsigned)point_tiles(p, P), (unsigned)m);
      return launch(remove_below_kernel<T, DR, P>, grid, ts.smem, s,
                    (const T*)x, p, d, c, cv, k, ts.kt, v, alive, alive_new,
                    live);
    }
  });
}

// Draw off. part holds nb floats, at least one a tile (seed_tile_rows;
// the wrapper's kernels/fused_lloyd.py::seed_tiles); sms is the card's
// SMs.
extern "C" int rt_update_min_dist(const void* x, int dtype, long long n,
                                  int d, const float* w, const float* d2,
                                  const float* c, const uint8_t* cv, int k,
                                  float* d2_new, float* part, long long nb,
                                  float* mass, int sms, void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  long long tiles = 0;
  cudaError_t e = dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    if constexpr (DR == 0) {
      tiles = (n + kTilePoints - 1) / kTilePoints;
      if (tiles > nb) return cudaErrorInvalidValue;
      if (n == 0) return cudaGetLastError();
      const T* xt = (const T*)x;
      if (k == 1) {
        return launch(tiled_seed_kernel<T, false>, dim3((unsigned)tiles),
                      sizeof(SeedSmem), s, xt, n, d, copies16<T>(x, d), w,
                      d2, d2_new, c, cv, part, nullptr, nullptr, nullptr,
                      nullptr, nullptr, 0, 0ll);
      }
      return launch(tiled_update_kernel<T>, dim3((unsigned)tiles),
                    sizeof(TiledSmem), s, xt, n, d, c, cv, k,
                    copies16<T>(x, d), copies16<float>(c, d), w, d2, d2_new,
                    part);
    } else {
      const int kt = tile_shape(DR, k).kt;
      const SeedShape ss = seed_shape(n, d, (int)sizeof(T), kt, DR);
      tiles = ss.tiles;
      if (tiles > nb) return cudaErrorInvalidValue;
      if (n == 0) return cudaGetLastError();
      auto kern = seed_step_kernel<T, DR, false>;
      long long grid = 0;
      const cudaError_t e = one_wave(kern, ss.smem, sms, tiles, &grid);
      if (e != cudaSuccess) return e;
      kern<<<(unsigned)grid, kThreads, ss.smem, s>>>(
          (const T*)x, n, d, ss.tile_rows, ss.sbytes, w, d2, d2_new, c, cv, k,
          kt, part, nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0ll);
      return cudaGetLastError();
    }
  });
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_rows(part, tiles, 1, mass, s);
}

// A whole weighted k-means++ seeding of n < 2^31 points: step 0, then
// steps 1 to k - 1, back to back on the stream, then the (k,) chosen
// indices into idx_out. d2 holds +inf and win_d2, win_w (k words each)
// hold 0 on entry; seed is the (2,) key. k + 1 launches, no host read.
extern "C" int rt_kmeanspp(const void* x, int dtype, long long n, int d,
                           const float* w, int k, const long long* seed,
                           float* d2, unsigned long long* win_d2,
                           unsigned long long* win_w, long long* idx_out,
                           int sms, void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  if (k <= 0) return cudaSuccess;
  const cudaError_t e = seed_steps(x, dtype, n, d, w, seed, d2, 0, k,
                                   nullptr, nullptr, nullptr, 0, win_d2,
                                   win_w, sms, s);
  if (e != cudaSuccess) return (int)e;
  seed_indices_kernel<<<(unsigned)((k + kThreads - 1) / kThreads), kThreads,
                        0, s>>>(win_d2, win_w, k, idx_out);
  return (int)cudaGetLastError();
}

// One draw-on step, for checks and timing: step `step` with the center
// given by the words (prev_d2, prev_w) (NULL: none, as step 0), d2
// updated in place, the step's words into out_d2 and out_w (zeroed by the
// caller).
extern "C" int rt_kmeanspp_step(const void* x, int dtype, long long n,
                                int d, const float* w, const long long* seed,
                                int step, float* d2,
                                const unsigned long long* prev_d2,
                                const unsigned long long* prev_w,
                                unsigned long long* out_d2,
                                unsigned long long* out_w, int sms,
                                void* stream) {
  using namespace rt;
  return (int)seed_steps(x, dtype, n, d, w, seed, d2, step, 1, prev_d2,
                         prev_w, nullptr, 0, out_d2, out_w, sms,
                         (cudaStream_t)stream);
}

// One draw-on step over one part of a larger point set (a mesh rank's
// rows), as step `step` of a seeding of the whole set keyed by seed: the
// part's rows are the whole set's rows base .. base + n - 1, so the
// Philox counters and the words' indices are those global indices. d2 is
// lowered in place against `center` (d float32 values; NULL: no center,
// as step 0) and the step's words over the part go to out_d2 and out_w
// (zeroed by the caller); the largest word of each kind over every part
// is the one-call step's over the whole set.
extern "C" int rt_kmeanspp_step_at(const void* x, int dtype, long long n,
                                   int d, const float* w,
                                   const long long* seed, int step,
                                   long long base, const float* center,
                                   float* d2, unsigned long long* out_d2,
                                   unsigned long long* out_w, int sms,
                                   void* stream) {
  using namespace rt;
  if (base < 0 || base + n > (1ll << 31)) return (int)cudaErrorInvalidValue;
  return (int)seed_steps(x, dtype, n, d, w, seed, d2, step, 1, nullptr,
                         nullptr, center, base, out_d2, out_w, sms,
                         (cudaStream_t)stream);
}
