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
// need. Design: min_dist's register-blocked walk (common.cuh:
// nearest_split, one slice: the 10 M points fill the card in every
// cell) over a grid of (point tile, machine), P points a thread; the
// threshold v is read through a device pointer, so the host never waits
// for it; each block counts its survivors (one __syncthreads_count per
// point slot of the thread, summed) and adds them to its machine's int32
// count with one atomicAdd. The (m, p) distance array never exists. Each
// point's d2 is min_dist's to the bit, so the mask is exactly
// alive & (min_dist's d2 > v). Blocks an SM, from ptxas: 110 registers
// at P = 4 (d <= 16), so 2; 72 at P = 2 (any d), so 3.
template <typename T, int DR, int P>
__global__ void __launch_bounds__(kThreads, P <= 2 ? 3 : 2)
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


// ------------------------------------------------------- D² seeding step
// Replaces repro/kernels/fused_lloyd.py::update_min_dist_pallas
// (pallas_call at fused_lloyd.py:370) and its big-n twin
// update_min_dist_pipelined_pallas (fused_lloyd.py:467), and with them the
// categorical draw that repro/core/kmeans.py:28-31 and :56-58 make after
// each call (XLA fuses it into the lax.scan step there).
//
// One template, two modes:
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
// Per point the arithmetic is nearest()'s (common.cuh): the same fmaf
// chains for ||x||^2 and x.c, t = fmaf(-2, x.c, ||c||^2), clamp0(t +
// ||x||^2) and a strict <. So both modes give the same d2 for the same
// center, bit for bit, and it is min_dist's d2 for a one-center block.
//
// Random bits: Philox4x32-10, written out below (no cuRAND). The key is a
// 64-bit seed that the wrapper draws once a seeding from the caller's
// torch.Generator, as a (2,) device tensor read through a pointer (never
// by the host); the counter is (point index, step, 0, 0); word 0 gives
// u = (2·(r >> 9) + 1)·2^-24, exact in float32 and never 0 or 1. The
// counter does not depend on the launch shape, so the plain version
// (kernels/ref.py) draws the same bits.
//
// Bound: bytes. A step at SOCCER k = 1000's coordinator (991,418 x 15,
// float32) reads x (59.5 MB), w and d2 and writes d2: 71.4 MB, 21.3 us at
// 3.35 TB/s; its 2·15 FMAs and one Philox block a point are far below the
// card's rates. Design, in both modes: one wave of blocks (the occupancy
// query's blocks an SM times the SMs), each walking a grid-stride loop over
// tiles of contiguous rows (256 rows while they fit kStageMax bytes), staged
// into shared memory by TMA bulk copies (one thread issues a tile's rows, w
// and d2 against the stage's mbarrier) and double-buffered: tile t + grid is
// in flight while tile t is computed, so no load waits on the compute path,
// and no thread spends instructions on addresses. Each step after the first
// is a programmatic dependent launch of the one before: its blocks start as
// the step before's leave the SMs and put their first tile's rows and w in
// flight before they wait for it, so the launch gap and the first load
// overlap the step before's tail. That early read is safe because no step
// writes x or w; the first step of a C call waits for everything before it
// (an ordinary launch), so x and w are whatever the stream wrote before the
// call. The w keys are computed only where they can be read (step 0, and a
// block with no D² key above -inf). A tile's base need not be 16-byte
// aligned (a machine's slice x[j] of an (m, p, d) tensor starts
// j·p·d·itemsize bytes in): its copy is aligned down to 16 bytes, and the
// rows sit at that offset in shared memory. The aligned copy reads at most
// 15 bytes on either side of the rows, inside the same allocation: PyTorch's
// allocations start and end on 512-byte boundaries. One C call (rt_kmeanspp)
// launches the k steps of a seeding back to back, then one small kernel that
// writes the k chosen indices, so the host does nothing a step and reads
// nothing back.

constexpr int kStageMax = 48 * 1024;       // bytes of rows a stage, at most
constexpr uint32_t kNegInfKey = 0x007FFFFFu;   // key_word's bits of -inf

// Rows of a staged tile: kThreads, or as many as kStageMax holds.
__host__ __device__ inline int seed_tile_rows(int d, int itemsize) {
  const long long row = (long long)(d > 0 ? d : 1) * itemsize;
  const long long r = kStageMax / row;
  return (int)(r >= kThreads ? kThreads : (r > 1 ? r : 1));
}

// Bytes of one stage buffer: a tile of rows plus up to 16 bytes of
// alignment on either side, a multiple of 16.
__host__ __device__ inline int stage_bytes(int rows, int d, int itemsize) {
  return (rows * d * itemsize + 15) / 16 * 16 + 32;
}

// TMA bulk copies (cp.async.bulk) into shared memory, each completing on
// a stage's mbarrier: one thread arms the barrier with the bytes a tile's
// copies will bring (barrier_expect) and issues them; every thread waits
// on the barrier's phase before it reads the tile.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void barrier_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void barrier_expect(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void barrier_wait(unsigned long long* bar,
                                             unsigned phase) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tWAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@p bra DONE;\n\tbra WAIT;\n\tDONE:\n\t}\n" ::"r"(smem_addr(bar)),
      "r"(phase)
      : "memory");
}

// Length of the 16-byte-aligned range around [src, src + nbytes).
__device__ __forceinline__ unsigned aligned_len(const unsigned char* src,
                                                long long nbytes) {
  const unsigned long long s = (unsigned long long)src;
  return (unsigned)(((s + nbytes + 15) & ~15ull) - (s & ~15ull));
}

// One bulk copy of that aligned range into dst (16-byte aligned).
__device__ __forceinline__ void bulk_copy(unsigned char* dst,
                                          const unsigned char* src,
                                          long long nbytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"((unsigned long long)src & ~15ull), "r"(aligned_len(src, nbytes)),
      "r"(smem_addr(bar))
      : "memory");
}

// Byte offset of src in its stage buffer.
__device__ __forceinline__ int stage_offset(const unsigned char* src) {
  return (int)((unsigned long long)src & 15ull);
}

// Programmatic dependent launch (sm_90): a draw-on step is launched while
// the step before it runs; launch_dependents lets the next step's blocks
// start as this step's blocks leave the SMs, and wait_prerequisites blocks
// until the step before has finished and its writes are visible. Without
// a programmatic launch both return at once.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

// The centers [t0, t0 + rows) into the shared tile, laid out as nearest()
// lays it out (rows `stride` floats apart, zero-padded past d, then kt
// ||c||^2, +inf for an invalid center). Draw on, the one center is row
// `win` of x, widened; draw off, rows of the float32 centers c. Every
// thread of the block must call this.
template <typename T, int DR, bool kDraw>
__device__ __forceinline__ void load_centers(
    const T* __restrict__ x, long long win, const float* __restrict__ c,
    const uint8_t* __restrict__ cv, int d, int t0, int rows, int kt,
    float* sc) {
  const int stride = DR > 0 ? DR : d;
  float* sc2 = sc + (size_t)kt * stride;
  __syncthreads();                             // last tile fully consumed
  for (int e = threadIdx.x; e < rows * stride; e += blockDim.x) {
    const int j = e / stride;
    const int q = e - j * stride;
    float v = 0.f;
    if (q < d) {
      if constexpr (kDraw) {
        v = widen(x[win * d + q]);
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

// One thread's point, its row staged in shared memory: the row in DR
// registers (zero-padded past d) or re-read from shared memory (DR == 0,
// any d), and ||x||^2 as nearest() computes it.
template <typename T, int DR>
struct StagedRow {
  static constexpr int kRegs = DR > 0 ? DR : 1;
  const T* row;
  float xr[kRegs];
  float x2;

  __device__ __forceinline__ StagedRow(const T* r, bool active, int d)
      : row(r) {
    x2 = 0.f;
    if (DR > 0) {
#pragma unroll
      for (int q = 0; q < kRegs; ++q) {
        xr[q] = (active && q < d) ? widen(r[q]) : 0.f;
        x2 = fmaf(xr[q], xr[q], x2);
      }
    } else if (active) {
      for (int q = 0; q < d; ++q) {
        const float v = widen(r[q]);
        x2 = fmaf(v, v, x2);
      }
    }
  }

  // best = min(best, t) over the `rows` centers of the shared tile.
  __device__ __forceinline__ void walk(const float* sc, const float* sc2,
                                       int rows, int d, float& best) const {
    const int stride = DR > 0 ? DR : d;
    for (int j = 0; j < rows; ++j) {
      float dot = 0.f;
      if (DR > 0) {
        const float4* cr =
            reinterpret_cast<const float4*>(sc + (size_t)j * stride);
#pragma unroll
        for (int q = 0; q < kRegs / 4; ++q) {
          const float4 v = cr[q];
          dot = fmaf(xr[4 * q], v.x, dot);
          dot = fmaf(xr[4 * q + 1], v.y, dot);
          dot = fmaf(xr[4 * q + 2], v.z, dot);
          dot = fmaf(xr[4 * q + 3], v.w, dot);
        }
      } else {
        const float* cr = sc + (size_t)j * stride;
        for (int q = 0; q < d; ++q) dot = fmaf(widen(row[q]), cr[q], dot);
      }
      const float t = fmaf(-2.f, dot, sc2[j]);
      if (t < best) best = t;
    }
  }
};

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

// Element 0 of src's copy in the stage part that begins at part.
template <typename V>
__device__ __forceinline__ const V* staged(const unsigned char* part,
                                           const void* src) {
  return reinterpret_cast<const V*>(
      part + stage_offset(reinterpret_cast<const unsigned char*>(src)));
}

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
                     const long long* __restrict__ seed, int step) {
  extern __shared__ __align__(16) unsigned char smem_u8[];
  unsigned char* stage[2] = {smem_u8, smem_u8 + sbytes};
  float* sc = reinterpret_cast<float*>(smem_u8 + 2 * (size_t)sbytes);
  const float* sc2 = sc + (size_t)kt * (DR > 0 ? DR : d);

  int kc = k;                                  // centers this step walks
  if constexpr (kDraw) kc = prev_w != nullptr ? 1 : 0;
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
    if (kc) win = winner_of(__ldcg(prev_d2), __ldcg(prev_w));
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
      const T* srow = staged<T>(stage[b], x + r0 * d) +
                      (size_t)(active ? threadIdx.x : 0) * d;
      const StagedRow<T, DR> r(srow, active, d);
      float best = INFINITY;
      if (resident) {
        if (active) r.walk(sc, sc2, kc, d, best);
      } else {
        for (int t0 = 0; t0 < kc; t0 += kt) {
          const int rows_c = min(kt, kc - t0);
          load_centers<T, DR, kDraw>(x, win, c, cv, d, t0, rows_c, kt, sc);
          if (active) r.walk(sc, sc2, rows_c, d, best);
        }
      }
      if (active) {
        const float cand = clamp0(best + r.x2);
        nd = cand < nd ? cand : nd;
      }
    }
    if constexpr (kDraw) {
      if (active) {
        if (kc > 0) d2_out[i] = nd;            // in place: this thread's
        const float g =
            gumbel(philox_word0((uint32_t)i, (uint32_t)step, k0, k1));
        const float wi = sw[threadIdx.x];
        if (kc > 0) {
          const unsigned long long kd = key_word(gumbel_key(wi * nd, g), i);
          best_d = kd > best_d ? kd : best_d;
        } else {
          const unsigned long long kw = key_word(gumbel_key(wi, g), i);
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
          const float g =
              gumbel(philox_word0((uint32_t)i, (uint32_t)step, k0, k1));
          const unsigned long long kw = key_word(gumbel_key(w[i], g), i);
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

// idx[i] = the winner of step i, for i < k.
__global__ void __launch_bounds__(kThreads)
    seed_indices_kernel(const unsigned long long* __restrict__ win_d2,
                        const unsigned long long* __restrict__ win_w, int k,
                        long long* __restrict__ idx) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < k) idx[i] = winner_of(win_d2[i], win_w[i]);
}

// Launch shape of a seeding step: rows a tile, bytes a stage (the rows,
// w and d2), dynamic shared memory (two stages and a center tile of kt
// rows) and tiles.
struct SeedShape {
  int tile_rows;
  int sbytes;
  size_t smem;
  long long tiles;
};

inline SeedShape seed_shape(long long n, int d, int itemsize, int kt,
                            int stride) {
  SeedShape s;
  s.tile_rows = seed_tile_rows(d, itemsize);
  s.sbytes = stage_bytes(s.tile_rows, d, itemsize) +
             2 * stage_bytes(s.tile_rows, 1, 4);
  s.smem = 2 * (size_t)s.sbytes + ((size_t)kt * stride + kt) * sizeof(float);
  s.tiles = (n + s.tile_rows - 1) / s.tile_rows;
  return s;
}

// One wave of a seed_step_kernel instance's blocks at `smem` bytes of
// shared memory, at most `tiles`; raises the kernel's limit first.
template <typename K>
inline cudaError_t one_wave(K kern, size_t smem, int sms, long long tiles,
                            long long* grid) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  const long long g = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  *grid = g < tiles ? g : tiles;
  return cudaSuccess;
}

// `count` draw-on steps from step `first`: the first reads its center's
// words from (prev_d2, prev_w) (NULL: no center), each later one from the
// step before it; step first + i writes win_d2[i] and win_w[i]. The first
// is an ordinary launch, each later one a programmatic dependent.
inline cudaError_t seed_steps(const void* x, int dtype, long long n, int d,
                              const float* w, const long long* seed,
                              float* d2, int first, int count,
                              const unsigned long long* prev_d2,
                              const unsigned long long* prev_w,
                              unsigned long long* win_d2,
                              unsigned long long* win_w, int sms,
                              cudaStream_t s) {
  if (n <= 0 || n >= (1ll << 31)) return cudaErrorInvalidValue;
  return dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    const SeedShape ss =
        seed_shape(n, d, (int)sizeof(T), 1, DR > 0 ? DR : d);
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
    const T* xt = (const T*)x;
    const float* none_f = nullptr;
    const uint8_t* none_u8 = nullptr;
    float* no_part = nullptr;
    for (int i = 0; i < count; ++i) {
      cfg.numAttrs = i ? 1 : 0;                // the first waits for all
      const unsigned long long* pd = i ? win_d2 + i - 1 : prev_d2;
      const unsigned long long* pw = i ? win_w + i - 1 : prev_w;
      e = cudaLaunchKernelEx(&cfg, kern, xt, n, d, ss.tile_rows, ss.sbytes,
                             w, (const float*)d2, d2, none_f, none_u8, 1, 1,
                             no_part, pd, pw, win_d2 + i, win_w + i, seed,
                             first + i);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
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
    // min_dist's points a thread: rows in registers, or re-read
    constexpr int P = DR > 0 ? 4 : 2;
    const TileShape ts = tile_shape(d, DR, k);
    if (m == 0 || p == 0) return cudaGetLastError();
    const dim3 grid((unsigned)point_tiles(p, P), (unsigned)m);
    return launch(remove_below_kernel<T, DR, P>, grid, ts.smem, s,
                  (const T*)x, p, d, c, cv, k, ts.kt, v, alive, alive_new,
                  live);
  });
}

// Draw off. part holds nb floats, at least one a tile (seed_shape; the
// wrapper's kernels/fused_lloyd.py::seed_tiles); sms is the card's SMs.
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
    const int kt = tile_shape(d, DR, k).kt;
    const SeedShape ss = seed_shape(n, d, (int)sizeof(T), kt,
                                    DR > 0 ? DR : d);
    tiles = ss.tiles;
    if (tiles > nb) return cudaErrorInvalidValue;
    if (n == 0) return cudaGetLastError();
    auto kern = seed_step_kernel<T, DR, false>;
    long long grid = 0;
    const cudaError_t e = one_wave(kern, ss.smem, sms, tiles, &grid);
    if (e != cudaSuccess) return e;
    kern<<<(unsigned)grid, kThreads, ss.smem, s>>>(
        (const T*)x, n, d, ss.tile_rows, ss.sbytes, w, d2, d2_new, c, cv, k,
        kt, part, nullptr, nullptr, nullptr, nullptr, nullptr, 0);
    return cudaGetLastError();
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
                                   nullptr, nullptr, win_d2, win_w, sms, s);
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
                         prev_w, out_d2, out_w, sms, (cudaStream_t)stream);
}
