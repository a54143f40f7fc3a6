// Shared device code of the port's clustering kernels (sm_90a).
//
// Every kernel here answers "which valid center is nearest to this point",
// with the center set streamed through shared memory in tiles, on one
// per-point arithmetic (bit for bit), in one of three walks:
//   tiled_nearest    d > 16 in min_dist, the Lloyd step and remove_below
//                    (min_dist.cu, fused_assign.cu, fused_lloyd.cu), and
//                    in the draw-off seeding step against more than one
//                    center: a tile of points against a tile of centers a
//                    block, both staged through shared memory by
//                    cp.async, a register tile of (point, center) pairs a
//                    thread;
//   nearest_split    P points a thread (nearest_blocked), the center axis
//                    optionally split over blocks: min_dist, the Lloyd
//                    step and remove_below at d <= 16 (each point's row
//                    in registers), and sensitivity_scores and
//                    truncated_cost at every d (past 16 each row re-read
//                    for every center);
//   one center       one point a thread, no argmin: the seeding step
//                    (fused_lloyd.cu: seed_walk on register rows at
//                    d <= 16; tiled_seed_kernel's point stages past 16).
// The per-point arithmetic: ||x||^2 and each x.c are fmaf chains over
// q = 0 .. DR-1 (the row zero-padded past d) or 0 .. d-1, t = fmaf(-2,
// x.c, ||c||^2) with ||c||^2 from the same chain, the least t over
// ascending centers by a strict <, and d2 = clamp0(t + ||x||^2).
// truncated_cost and the seeding step read their rows from tiles staged
// in shared memory by TMA bulk copies (smem_addr .. stage_offset below),
// the tiled walk from stages filled by cp.async; the others read them
// from device memory.
// Sums by center are exact fixed-point sums, grouped by center within
// each warp before they touch memory (WarpGroups, GroupAcc, put_point):
// the Lloyd step's, lloyd_reduce's and sensitivity_scores' masses.
// The distance is the expanded form the JAX reference uses
// (repro/kernels/ref.py:43 and :72):
//
//     d2 = max(min_j(||c_j||^2 - 2 x.c_j) + ||x||^2, 0)
//
// in float32, never sum((x - c)^2): the removal threshold v is computed
// from these same d2 values, so every implementation has to make the same
// cancellation error (a few percent of d2 at the paper's sigma = 0.001).
//
// Points arrive as float32, bfloat16 or float16 and are widened on load;
// centers, weights and every float accumulator are float32. Centers are
// few next to the points (at most 173,256 rows, EIM11's clustering), so
// the wrapper hands them over in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <utility>

namespace rt {

constexpr int kThreads = 256;        // threads a block
constexpr int kTileFloats = 8192;    // 32 KB of centers per shared tile

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// Programmatic dependent launch (sm_90). A kernel launched by
// launch_ex(true, ...) may start while the kernel before it on the stream
// runs: once every block of that one has called launch_dependents (or
// left), the dependent's blocks take the SMs they find free, and
// wait_prerequisites blocks them until the kernel before has finished and
// its writes are visible. Without a programmatic launch both return at
// once.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prerequisites() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

__device__ __forceinline__ float clamp0(float v) {
  return v < 0.f ? 0.f : v;          // NaN passes through, as in torch.clamp
}

// ------------------------------------------------- staged point tiles
// TMA bulk copies (cp.async.bulk) into shared memory, each completing on
// a stage's mbarrier: one thread arms the barrier with the bytes a tile's
// copies will bring (barrier_expect) and issues them; every thread waits
// on the barrier's phase before it reads the tile. A tile's base need not
// be 16-byte aligned (a machine's slice x[j] of an (m, p, d) tensor
// starts j·p·d·itemsize bytes in): its copy is aligned down to 16 bytes,
// and the rows sit at that offset in shared memory (stage_offset). The
// aligned copy reads at most 15 bytes on either side of the rows, inside
// the same allocation: PyTorch's allocations start and end on 512-byte
// boundaries.
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

// Element 0 of src's copy in the stage part that begins at part.
template <typename V>
__device__ __forceinline__ const V* staged(const unsigned char* part,
                                           const void* src) {
  return reinterpret_cast<const V*>(
      part + stage_offset(reinterpret_cast<const unsigned char*>(src)));
}

// Bytes of one stage buffer: a tile of rows plus up to 16 bytes of
// alignment on either side, a multiple of 16.
__host__ __device__ inline int stage_bytes(int rows, int d, int itemsize) {
  return (rows * d * itemsize + 15) / 16 * 16 + 32;
}

// ------------------------------------------- register-blocked center walk
// P points a thread: each center row read from shared memory feeds P·DR
// FMAs, and its ||c||^2 is read once for the P points. Per point the
// arithmetic is the one above, so every kernel on this walk gives
// min_dist's argmin and min-d2, bit for bit.
//
// Rows<T, DR, P> holds the thread's P points: their rows in registers
// (DR > 0, zero-padded past d) or their row pointers (DR == 0, any d,
// re-read for every center), and ||x||^2. Point p of the thread is row
// first + p·blockDim.x of the n rows; a row past n is inactive and reads
// row lo. The rows are read from `rows`, which holds rows lo, lo + 1, ...
// of the points: the points themselves (lo = 0), or a tile of them staged
// in shared memory (lo = the tile's first row).
template <typename T, int DR, int P>
struct Rows {
  static constexpr int kRegs = DR > 0 ? DR : 1;
  const T* row[P];
  long long idx[P];
  bool active[P];
  float xr[P][kRegs];
  float x2[P];

  __device__ __forceinline__ Rows(const T* __restrict__ x, long long n,
                                  int d, long long first)
      : Rows(x, 0, n, d, first) {}

  __device__ __forceinline__ Rows(const T* __restrict__ rows, long long lo,
                                  long long n, int d, long long first) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      idx[p] = first + (long long)p * blockDim.x;
      active[p] = idx[p] < n;
      row[p] = rows + ((active[p] ? idx[p] : lo) - lo) * d;
      x2[p] = 0.f;
      if (DR > 0) {
#pragma unroll
        for (int q = 0; q < kRegs; ++q) {
          xr[p][q] = (active[p] && q < d) ? widen(row[p][q]) : 0.f;
          x2[p] = fmaf(xr[p][q], xr[p][q], x2[p]);
        }
      } else if (active[p]) {
        for (int q = 0; q < d; ++q) {
          const float v = widen(row[p][q]);
          x2[p] = fmaf(v, v, x2[p]);
        }
      }
    }
  }
};

// Centers [t0, t0 + rows) of c into the shared tile: kt rows of `stride`
// floats (DR, or d; zero-padded past d), then kt ||c||^2, +inf for an
// invalid center. Every thread of the block must call this (it holds
// __syncthreads on both sides: the tile before is consumed, this one is
// ready).
__device__ __forceinline__ void load_center_tile(
    const float* __restrict__ c, const uint8_t* __restrict__ cv, int d,
    int stride, int t0, int rows, int kt, float* smem) {
  float* sc = smem;                            // (kt, stride) center rows
  float* sc2 = sc + (size_t)kt * stride;       // (kt,) ||c||^2, or +inf
  __syncthreads();                             // last tile fully consumed
  for (int e = threadIdx.x; e < rows * stride; e += blockDim.x) {
    const int j = e / stride;
    const int q = e - j * stride;
    sc[e] = q < d ? c[(size_t)(t0 + j) * d + q] : 0.f;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < rows; j += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < d; ++q) {
      const float v = sc[(size_t)j * stride + q];
      s = fmaf(v, v, s);
    }
    sc2[j] = (cv == nullptr || cv[t0 + j]) ? s : INFINITY;
  }
  __syncthreads();
}

// (best, arg) = the nearest of (best, arg) and the `rows` centers of the
// shared tile (load_center_tile's; absolute index t0 + j), for each of
// the thread's P points; with kArg false only best. An invalid center's
// ||c||^2 is +inf: its t is +inf (or NaN), never < best, so it is never
// chosen: no validity array and no branch in the walk.
template <typename T, int DR, int P, bool kArg>
__device__ __forceinline__ void scan_center_tile(
    const Rows<T, DR, P>& r, int d, int t0, int rows, int kt,
    const float* smem, float (&best)[P], int (&arg)[P]) {
  const int stride = DR > 0 ? DR : d;
  const float* sc = smem;
  const float* sc2 = sc + (size_t)kt * stride;
#pragma unroll 4
  for (int j = 0; j < rows; ++j) {
    float dot[P];
#pragma unroll
    for (int p = 0; p < P; ++p) dot[p] = 0.f;
    if (DR > 0) {
      const float4* cr =
          reinterpret_cast<const float4*>(sc + (size_t)j * stride);
#pragma unroll
      for (int q = 0; q < Rows<T, DR, P>::kRegs / 4; ++q) {
        const float4 v = cr[q];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          dot[p] = fmaf(r.xr[p][4 * q], v.x, dot[p]);
          dot[p] = fmaf(r.xr[p][4 * q + 1], v.y, dot[p]);
          dot[p] = fmaf(r.xr[p][4 * q + 2], v.z, dot[p]);
          dot[p] = fmaf(r.xr[p][4 * q + 3], v.w, dot[p]);
        }
      }
    } else {
      const float* cr = sc + (size_t)j * stride;
      for (int q = 0; q < d; ++q) {
        const float v = cr[q];
#pragma unroll
        for (int p = 0; p < P; ++p) {
          dot[p] = fmaf(widen(r.row[p][q]), v, dot[p]);
        }
      }
    }
    const float c2 = sc2[j];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float t = fmaf(-2.f, dot[p], c2);
      if (t < best[p]) {
        best[p] = t;
        if (kArg) arg[p] = t0 + j;
      }
    }
  }
}

// The nearest valid center among [j_lo, j_hi) of each of the thread's P
// points (absolute indices in arg; with kArg false only best, and arg
// stays 0), the centers streamed through the shared tile (kt rows) one
// tile at a time. Every thread of the block must call this (it holds
// __syncthreads).
template <typename T, int DR, int P, bool kArg = true>
__device__ __forceinline__ void nearest_blocked(
    const Rows<T, DR, P>& r, int d, const float* __restrict__ c,
    const uint8_t* __restrict__ cv, int j_lo, int j_hi, int kt, float* smem,
    float (&best)[P], int (&arg)[P]) {
  bool any_active = false;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best[p] = INFINITY;
    arg[p] = 0;
    any_active |= r.active[p];
  }
  for (int t0 = j_lo; t0 < j_hi; t0 += kt) {
    const int rows = min(kt, j_hi - t0);
    load_center_tile(c, cv, d, DR > 0 ? DR : d, t0, rows, kt, smem);
    if (any_active) {
      scan_center_tile<T, DR, P, kArg>(r, d, t0, rows, kt, smem, best, arg);
    }
  }
}

// ------------------------------------ the walk with the center axis split
// nearest_blocked over all k centers for one tile of the thread's P
// points, the center axis split into `slices` slices of `slice` centers
// over blocks: block s of the tile walks [s·slice, (s + 1)·slice). With
// one slice the walk is the whole result and no scratch is touched (the
// scratch pointers may be NULL). With more, each block writes its
// per-slice (best, arg) to row s of the (slices, n) scratch ws_best /
// ws_arg, and the last of the tile's blocks to finish (a counter a tile,
// tile_done, zeroed before the launch) combines the slices in slice order
// with a strict <: the first-index argmin of one sequential walk, so the
// split changes no bit. Returns true (uniformly over the block) in the
// block that holds the tile's combined (best, arg). Every thread of the
// block must call this. With kArg false only best is kept (ws_arg is not
// touched and may be NULL; arg stays 0).
template <typename T, int DR, int P, bool kArg = true>
__device__ __forceinline__ bool nearest_split(
    const Rows<T, DR, P>& r, long long n, int d, const float* __restrict__ c,
    const uint8_t* __restrict__ cv, int k, int slice, int s, int slices,
    long long tile, int kt, float* smem, unsigned* __restrict__ tile_done,
    float* __restrict__ ws_best, int* __restrict__ ws_arg,
    float (&best)[P], int (&arg)[P]) {
  const int j_lo = min(k, s * slice);
  const int j_hi = min(k, j_lo + slice);
  nearest_blocked<T, DR, P, kArg>(r, d, c, cv, j_lo, j_hi, kt, smem, best,
                                  arg);
  if (slices == 1) return true;
  const long long off = (long long)s * n;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (r.active[p]) {
      ws_best[off + r.idx[p]] = best[p];
      if (kArg) ws_arg[off + r.idx[p]] = arg[p];
    }
  }
  __threadfence();
  __syncthreads();
  __shared__ int last;
  if (threadIdx.x == 0) {
    last = atomicAdd(tile_done + tile, 1u) == (unsigned)slices - 1;
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best[p] = INFINITY;
    arg[p] = 0;
    if (!r.active[p]) continue;
    for (int q = 0; q < slices; ++q) {
      const float b = __ldcg(ws_best + (long long)q * n + r.idx[p]);
      if (b < best[p]) {
        best[p] = b;
        if (kArg) arg[p] = __ldcg(ws_arg + (long long)q * n + r.idx[p]);
      }
    }
  }
  return true;
}

// ------------------------------------------------ the tiled walk (d > 16)
// Past the register rows a block owns a tile of kTilePoints points
// against a tile of kTileCenters centers, and each thread a kTiledPPT ×
// kTiledCPT tile of float32 accumulators: points ty + 16·i and centers
// tx + 16·m of the two tiles (tx = threadIdx.x % 16, ty = threadIdx.x /
// 16). Both operands stream through two shared-memory stages of
// kTileDepth coordinates each, as point-major rows kTilePitch floats
// apart (float4 reads without bank conflicts): a point row is read from
// device memory once per center tile and a center row once per block and
// center tile, every read coalesced; a stage is filled while the one
// before is walked. Float32 rows (the centers always, float32 points) are
// copied by cp.async: 16 bytes a copy where d % 4 == 0 and the base is
// 16-byte aligned, else 4 bytes. bfloat16 and float16 point rows go
// through registers and are widened once, as they are stored: at odd d a
// 2-byte row has no 4-byte-aligned start for cp.async. The stages are
// zero past d, n and k.
//
// Per (point, center) the arithmetic is the walk's above, to the bit: the
// dot is one fmaf chain over q = 0 .. d-1 in ascending order (the zeros
// past d add fmaf(0, 0, dot) = dot, up to the sign of a zero, which t
// cannot see since ||c||^2 is never -0); ||x||^2 and ||c||^2 are the same
// chains, carried across the stages by threads 0-127 (a point each, on
// the first center tile) and 128-207 (a center each); t = fmaf(-2, dot,
// ||c||^2) with +inf for an invalid or padding center; the least t over
// ascending centers by a strict <: within a thread over its 5 centers in
// order, over the 16 lanes of a point as the least (t, index) pair (the
// first index of the least t: the sequential walk's choice), and across
// center tiles by a strict <. The d axis is never split; no tensor cores.
constexpr int kTiledPPT = 8;         // points of a thread's tile
constexpr int kTiledCPT = 5;         // centers of a thread's tile
constexpr int kTiledRows = kThreads / 16;       // point groups (ty)
constexpr int kTilePoints = kTiledRows * kTiledPPT;   // points a tile
constexpr int kTileCenters = 16 * kTiledCPT;   // centers a center tile
constexpr int kTileDepth = 32;       // coordinates a stage
constexpr int kTilePitch = kTileDepth + 4;   // floats a staged row
static_assert(kTilePoints + kTileCenters <= kThreads && kTiledPPT <= 16,
              "a norm chain a thread, and a point a lane of each group");

struct TiledSmem {
  float xs[2][kTilePoints * kTilePitch];     // the two point stages
  float cs[2][kTileCenters * kTilePitch];    // the two center stages
  float x2[kTilePoints];                     // ||x||^2 of the point tile
  float c2[2][kTileCenters];                 // ||c||^2 or +inf, by tile parity
  float part[kTilePoints];                   // a per-point epilogue value
};

// Block tiles of the tiled walk over n points (at least 1).
inline long long tiled_tiles(long long n) {
  const long long t = (n + kTilePoints - 1) / kTilePoints;
  return t > 1 ? t : 1;
}

// cp.async of 4 or 16 bytes into shared memory, zero-filled when !in
// (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The thread's copies issued since the last commit form one group; wait
// until at most N of its groups are still in flight.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether rows of d elements from `a` take 16-byte copies: float32, d a
// multiple of 4 and the base 16-byte aligned (every row then is too).
template <typename T>
inline bool copies16(const void* a, int d) {
  return std::is_same<T, float>::value && d % 4 == 0 &&
         (uintptr_t)a % 16 == 0;
}

// Rows [r0, r0 + kRows) of the (nrows, d) float32 matrix a, coordinates
// [q0, q0 + kTileDepth), copied into a stage; zero past d and nrows.
template <int kRows>
__device__ __forceinline__ void stage_f32(const float* __restrict__ a,
                                          long long nrows, int d,
                                          long long r0, int q0, bool vec,
                                          float* dst) {
  if (vec) {
    constexpr int kSegs = kTileDepth / 4;
#pragma unroll
    for (int e = threadIdx.x; e < kRows * kSegs; e += kThreads) {
      const int r = e / kSegs;
      const int q = q0 + 4 * (e - r * kSegs);
      const bool in = r0 + r < nrows && q < d;
      cp_async16(dst + r * kTilePitch + (q - q0),
                 a + (in ? (r0 + r) * d + q : 0), in);
    }
  } else {
#pragma unroll
    for (int e = threadIdx.x; e < kRows * kTileDepth; e += kThreads) {
      const int r = e / kTileDepth;
      const int q = q0 + (e - r * kTileDepth);
      const bool in = r0 + r < nrows && q < d;
      cp_async4(dst + r * kTilePitch + (q - q0),
                a + (in ? (r0 + r) * d + q : 0), in);
    }
  }
}

// A 2-byte point's bits widened to float32, exactly.
template <typename T>
__device__ __forceinline__ float widen_bits(unsigned short u) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return __uint_as_float((unsigned)u << 16);
  } else {
    return __half2float(__ushort_as_half(u));
  }
}

// stage_f32's rows of a 2-byte matrix, loaded through registers and
// widened as they are stored (at odd d a 2-byte row has no 4-byte-aligned
// start for cp.async).
template <typename T, int kRows>
__device__ __forceinline__ void stage_widened(const T* __restrict__ a,
                                              long long nrows, int d,
                                              long long r0, int q0,
                                              float* dst) {
  const unsigned short* ab = reinterpret_cast<const unsigned short*>(a);
#pragma unroll 4
  for (int e = threadIdx.x; e < kRows * kTileDepth; e += kThreads) {
    const int r = e / kTileDepth;
    const int q = q0 + (e - r * kTileDepth);
    dst[r * kTilePitch + (q - q0)] =
        (r0 + r < nrows && q < d) ? widen_bits<T>(ab[(r0 + r) * d + q])
                                  : 0.f;
  }
}

// stage_f32 for float32 rows, stage_widened for 2-byte ones.
template <typename T, int kRows>
__device__ __forceinline__ void stage_rows(const T* __restrict__ a,
                                           long long nrows, int d,
                                           long long r0, int q0, bool vec,
                                           float* dst) {
  if constexpr (std::is_same<T, float>::value) {
    stage_f32<kRows>(a, nrows, d, r0, q0, vec, dst);
  } else {
    stage_widened<T, kRows>(a, nrows, d, r0, q0, dst);
  }
}

// The nearest valid center of each point of the block tile that starts at
// row p0: on return every lane of a point group ty holds (best[i],
// arg[i]) of point p0 + ty + kTiledRows·i (+inf and 0 with no valid
// center; best is the least t, so d2 = clamp0(best + ||x||^2)), and
// sm.x2 holds the tile's ||x||^2. xvec and cvec: 16-byte copies of the
// point and center rows. Every thread of the block must call this.
template <typename T>
__device__ __forceinline__ void tiled_nearest(
    const T* __restrict__ x, long long n, int d, const float* __restrict__ c,
    const uint8_t* __restrict__ cv, int k, long long p0, bool xvec,
    bool cvec, TiledSmem& sm, float (&best)[kTiledPPT],
    int (&arg)[kTiledPPT]) {
  constexpr bool kAsync = std::is_same<T, float>::value;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int nq = (d + kTileDepth - 1) / kTileDepth;
  const int nct = k > kTileCenters ? (k + kTileCenters - 1) / kTileCenters
                                   : 1;
  const int steps = nq * nct;

  // step it = (center tile it / nq, stage of coordinates it % nq): its
  // copies are issued before the step before it is walked; 2-byte point
  // rows are loaded, widened and stored after it (no registers held
  // across the walk)
  auto issue = [&](int it, int s) {
    const int ct = it / nq;
    const int q0 = (it - ct * nq) * kTileDepth;
    if constexpr (kAsync) {
      stage_f32<kTilePoints>(reinterpret_cast<const float*>(x), n, d, p0,
                             q0, xvec, sm.xs[s]);
    }
    stage_f32<kTileCenters>(c, k, d, (long long)ct * kTileCenters, q0, cvec,
                            sm.cs[s]);
  };
  auto land = [&](int it, int s) {
    if constexpr (!kAsync) {
      stage_widened<T, kTilePoints>(x, n, d, p0,
                                    (it - it / nq * nq) * kTileDepth,
                                    sm.xs[s]);
    }
    cp_async_wait_all();
  };

#pragma unroll
  for (int i = 0; i < kTiledPPT; ++i) {
    best[i] = INFINITY;
    arg[i] = 0;
  }
  float acc[kTiledPPT][kTiledCPT];
  // ||x||^2 of point tid (tid < kTilePoints, on the first center tile),
  // or ||c||^2 of center tid - kTilePoints
  float chain = 0.f;
  const int jl = tid - kTilePoints;
  issue(0, 0);
  land(0, 0);
  __syncthreads();
  for (int it = 0; it < steps; ++it) {
    const int s = it & 1;
    const int ct = it / nq;
    const int ch = it - ct * nq;
    if (it + 1 < steps) issue(it + 1, s ^ 1);
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < kTiledPPT; ++i) {
#pragma unroll
        for (int m = 0; m < kTiledCPT; ++m) acc[i][m] = 0.f;
      }
      if (jl >= 0) chain = 0.f;
    }
    const float* xs = sm.xs[s];
    const float* cs = sm.cs[s];
#pragma unroll
    for (int q4 = 0; q4 < kTileDepth / 4; ++q4) {
      float4 cr[kTiledCPT];
#pragma unroll
      for (int m = 0; m < kTiledCPT; ++m) {
        cr[m] = *reinterpret_cast<const float4*>(
            cs + (tx + 16 * m) * kTilePitch + 4 * q4);
      }
#pragma unroll
      for (int i = 0; i < kTiledPPT; ++i) {
        const float4 xv = *reinterpret_cast<const float4*>(
            xs + (ty + kTiledRows * i) * kTilePitch + 4 * q4);
#pragma unroll
        for (int m = 0; m < kTiledCPT; ++m) {
          acc[i][m] = fmaf(xv.x, cr[m].x, acc[i][m]);
          acc[i][m] = fmaf(xv.y, cr[m].y, acc[i][m]);
          acc[i][m] = fmaf(xv.z, cr[m].z, acc[i][m]);
          acc[i][m] = fmaf(xv.w, cr[m].w, acc[i][m]);
        }
      }
    }
    const int lim = min(kTileDepth, d - ch * kTileDepth);
    const bool last = ch == nq - 1;
    if (jl < 0) {
      if (ct == 0) {
        const float* row = xs + tid * kTilePitch;
        for (int q = 0; q < lim; ++q) chain = fmaf(row[q], row[q], chain);
        if (last) sm.x2[tid] = chain;
      }
    } else if (jl < kTileCenters) {
      const float* row = cs + jl * kTilePitch;
      for (int q = 0; q < lim; ++q) chain = fmaf(row[q], row[q], chain);
      if (last) {
        const int j = ct * kTileCenters + jl;
        sm.c2[ct & 1][jl] =
            (j < k && (cv == nullptr || cv[j])) ? chain : INFINITY;
      }
    }
    if (it + 1 < steps) land(it + 1, s ^ 1);
    __syncthreads();
    if (!last) continue;
    const float* c2 = sm.c2[ct & 1];
#pragma unroll
    for (int i = 0; i < kTiledPPT; ++i) {
      float bt = INFINITY;
      int bj = INT_MAX;
#pragma unroll
      for (int m = 0; m < kTiledCPT; ++m) {
        const float t = fmaf(-2.f, acc[i][m], c2[tx + 16 * m]);
        if (t < bt) {
          bt = t;
          bj = ct * kTileCenters + tx + 16 * m;
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) {
        const float ot = __shfl_xor_sync(0xffffffffu, bt, o, 16);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, o, 16);
        if (ot < bt || (ot == bt && oj < bj)) {
          bt = ot;
          bj = oj;
        }
      }
      if (bt < best[i]) {
        best[i] = bt;
        arg[i] = bj;
      }
    }
  }
}

inline size_t round8(size_t b) { return (b + 7) / 8 * 8; }

// Point tiles of kThreads·P points over n (at least 1), the grid's x axis
// of every nearest_split kernel.
inline long long point_tiles(long long n, int ppt) {
  const long long t = (n + (long long)kThreads * ppt - 1) /
                      ((long long)kThreads * ppt);
  return t > 1 ? t : 1;
}

// Fixed-order block sum (warp shuffles, then one warp over the warp
// partials): the same inputs give the same bits on every run. The result
// is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();                             // warp_part free for reuse
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  const int nwarps = (blockDim.x + 31) >> 5;
  v = (warp == 0 && lane < nwarps) ? warp_part[lane] : 0.f;
  if (warp == 0) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  return v;
}

// out[e] = sum_b part[e * nb + b], one block per row, in a fixed order:
// the second pass of every cross-block float sum.
__global__ void __launch_bounds__(kThreads)
    reduce_rows_kernel(const float* __restrict__ part, long long nb,
                       float* __restrict__ out) {
  const float* row = part + (long long)blockIdx.x * nb;
  float acc = 0.f;
  for (long long b = threadIdx.x; b < nb; b += blockDim.x) acc += row[b];
  const float s = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

inline cudaError_t reduce_rows(const float* part, long long nb, long long rows,
                               float* out, cudaStream_t stream) {
  reduce_rows_kernel<<<(unsigned)rows, kThreads, 0, stream>>>(part, nb, out);
  return cudaGetLastError();
}

inline long long blocks_for(long long n) {
  return (n + kThreads - 1) / kThreads;
}

// ------------------------------------------ fixed-point center sums
// Exact sums at every k for the Lloyd step (fused_assign.cu),
// lloyd_reduce (lloyd.cu) and sensitivity_scores' masses
// (sensitivity.cu): each term w·x_q is formed exactly in double, scaled
// by 2^s and rounded once to an int64, and added into its center's
// (d + 1)-wide accumulator row with integer adds; the last column takes
// w at its own scale (the masses are that column alone). s is the
// largest shift with n·max|w|·max|x|·2^s < 2^62, so no center's sum can
// overflow. Integer
// addition is exact and associative: the accumulators hold the same bits
// whatever order the blocks run in. Each term's rounding error is at most
// 2^-(s+1), i.e. about n·max|w|·max|x|·2^-63: far below float32's own
// resolution of the sums. Zero-weight points add nothing (their terms are
// exactly 0), so they skip the atomics.

// bound[0] = max |w_i|, bound[1] = max |x_iq| over rows with w_i != 0, as
// float bits (atomicMax on the bit patterns of non-negative floats is
// exact in any order); the caller zeroes both. Finite inputs are assumed:
// NaN is skipped by fmaxf, an infinity makes the shift meaningless.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bound_kernel(const T* __restrict__ x, long long n, int d,
                 const float* __restrict__ w, unsigned* __restrict__ bound) {
  // Each block takes kThreads rows at a time: their weights are staged in
  // shared memory, then their kThreads·d coordinates are read
  // contiguously, one a thread at a time, each thread stepping its (row,
  // column) by kThreads elements with no division.
  __shared__ float sw[kThreads];
  float mw = 0.f, mx = 0.f;
  const int row0 = d > 0 ? (int)threadIdx.x / d : 0;
  const int col0 = d > 0 ? (int)threadIdx.x - row0 * d : 0;
  const int step_r = d > 0 ? kThreads / d : 0;
  const int step_c = d > 0 ? kThreads - step_r * d : 0;
  for (long long r0 = (long long)blockIdx.x * kThreads; r0 < n;
       r0 += (long long)gridDim.x * kThreads) {
    const int rows = (int)min((long long)kThreads, n - r0);
    __syncthreads();                           // sw free for reuse
    if ((int)threadIdx.x < rows) {
      sw[threadIdx.x] = w[r0 + threadIdx.x];
      mw = fmaxf(mw, fabsf(sw[threadIdx.x]));
    }
    __syncthreads();
    const T* xb = x + r0 * d;
    int r = row0, q = col0;
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * d; e += kThreads) {
      if (sw[r] != 0.f) mx = fmaxf(mx, fabsf(widen(xb[e])));
      r += step_r;
      q += step_c;
      if (q >= d) {
        q -= d;
        ++r;
      }
    }
  }
  // one atomicMax pair a block: atomics on one address serialize
  __shared__ float smw[kThreads / 32], smx[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    mw = fmaxf(mw, __shfl_down_sync(0xffffffffu, mw, o));
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, o));
  }
  if ((threadIdx.x & 31) == 0) {
    smw[threadIdx.x >> 5] = mw;
    smx[threadIdx.x >> 5] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kThreads / 32; ++i) {
      mw = fmaxf(mw, smw[i]);
      mx = fmaxf(mx, smx[i]);
    }
    atomicMax(bound, __float_as_uint(mw));
    atomicMax(bound + 1, __float_as_uint(mx));
  }
}

// Blocks of the bound pass over n rows: enough to read x at the memory's
// rate, few enough that its two atomics a block stay cheap.
inline unsigned bound_grid(long long n) {
  const long long b = (n + kThreads - 1) / kThreads;
  return (unsigned)(b < 1 ? 1 : (b > 1024 ? 1024 : b));
}

// bound[0] = max |w_i| as float bits, bound_kernel's, from a pass over w
// alone (sensitivity_scores' masses); the caller zeroes it. Few blocks,
// eight loads in flight a thread: the walk launched after it
// (launch_ex) takes the rest of the SMs meanwhile.
constexpr int kMaxAbsBlocks = 128;

__global__ void __launch_bounds__(kThreads)
    max_abs_kernel(const float* __restrict__ w, long long n,
                   unsigned* __restrict__ bound) {
  launch_dependents();
  const long long stride = (long long)gridDim.x * kThreads;
  long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  float m = 0.f;
  for (; i + 7 * stride < n; i += 8 * stride) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = w[i + u * stride];
#pragma unroll
    for (int u = 0; u < 8; ++u) m = fmaxf(m, fabsf(v[u]));
  }
  for (; i < n; i += stride) m = fmaxf(m, fabsf(w[i]));
  __shared__ float sm[kThreads / 32];
  for (int o = 16; o > 0; o >>= 1) {
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, o));
  }
  if ((threadIdx.x & 31) == 0) sm[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 1; j < kThreads / 32; ++j) m = fmaxf(m, sm[j]);
    atomicMax(bound, __float_as_uint(m));
  }
}

inline unsigned max_abs_grid(long long n) {
  const long long b = (n + 8ll * kThreads - 1) / (8ll * kThreads);
  return (unsigned)(b < 1 ? 1 : (b > kMaxAbsBlocks ? kMaxAbsBlocks : b));
}

// The largest s with b·2^s < 2^62 (0 when b == 0: every term is then 0).
__device__ __forceinline__ int fixed_shift(double b) {
  if (!(b > 0.0)) return 0;
  int e;
  frexp(b, &e);                                  // b < 2^e
  return 62 - e;
}

struct Shifts {
  int x;   // of the weighted coordinates w·x
  int w;   // of the weights
};

__device__ __forceinline__ Shifts shifts(const unsigned* bound, long long n) {
  const double mw = (double)__uint_as_float(bound[0]);
  const double mx = (double)__uint_as_float(bound[1]);
  return {fixed_shift((double)n * mw * mx), fixed_shift((double)n * mw)};
}

// The warp's points grouped by center before they touch the accumulators.
// Each lane brings one point's key (its center, or -1 for a point that
// adds nothing); __match_any_sync finds the lanes of each key, and a tree
// over each group's members in lane order (the member of rank r takes
// rank r + o at step o) leaves the group's sums in its rank-0 lane, the
// leader. Integer sums: any grouping gives the same bits. All 32 lanes
// must construct it and call sum() together.
struct WarpGroups {
  static constexpr unsigned kFull = 0xffffffffu;
  int steps;          // ceil(log2(largest group in the warp))
  bool leader;
  int src[5];
  bool take[5];

  __device__ __forceinline__ explicit WarpGroups(int key) {
    const int lane = threadIdx.x & 31;
    const unsigned grp = __match_any_sync(kFull, key);
    const int rank = __popc(grp & ((1u << lane) - 1u));
    const int size = __popc(grp);
    leader = rank == 0 && key >= 0;
    steps = 32 - __clz(__reduce_max_sync(kFull, (unsigned)size) - 1u);
    unsigned above = lane == 31 ? 0u : grp & (kFull << (lane + 1));
    int have = 1;                              // rank gap to above's lowest
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int o = 1 << s;
      for (; have < o && above; ++have) above &= above - 1u;
      take[s] = s < steps && (rank & (2 * o - 1)) == 0 && rank + o < size;
      src[s] = take[s] ? __ffs(above) - 1 : lane;
    }
  }

  // N columns at once: N independent shuffles a step.
  template <int N>
  __device__ __forceinline__ void sum(unsigned long long (&v)[N]) const {
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      if (s < steps) {                         // uniform over the warp
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const unsigned long long o = __shfl_sync(kFull, v[i], src[s]);
          if (take[s]) v[i] += o;
        }
      }
    }
  }
};

// v·2^s rounded to the nearest int64, ties to even (llrint(ldexp(v, s))
// for every finite term; scale = 2^s).
__device__ __forceinline__ unsigned long long to_fixed_scaled(double v,
                                                              double scale) {
  return (unsigned long long)__double2ll_rn(v * scale);
}

// Where a group's totals go (the wrapper picks by the accumulator entries:
// kernels/fused_lloyd.py::acc_mode):
enum AccMode {
  kGlobalAcc = 0,   // straight into the global accumulators
  kWarpAcc = 1,     // each warp's own shared rows (no atomics: a warp's
                    // leaders hold distinct keys and its points come one
                    // after another), summed and flushed once a block:
                    // k·cols <= kWarpAccEntries
};
constexpr int kWarpAccEntries = 1024;

// A warp's shared row of `cols` int64 entries is padded to an odd number
// of words, so that the leaders of different keys, adding into one column
// at once, fall on different banks (a row of 16 words, the paper's
// d = 15, put every key's entry of a column on one bank).
__host__ __device__ inline int acc_pitch(int cols) { return cols | 1; }

__host__ __device__ inline size_t acc_smem(int mode, int k, int cols) {
  const size_t b = mode == kWarpAcc
                       ? (size_t)k * acc_pitch(cols) * 8 * (kThreads / 32)
                       : 0;
  return (b + 15) / 16 * 16;
}

// The accumulators a block adds its group totals into: k rows of `cols`
// int64 in device memory (acc, zeroed before the launch) and, in kWarpAcc
// mode, each warp's own copy at the start of the dynamic shared memory
// (acc_smem bytes, rows acc_pitch(cols) apart), which each warp zeroes
// here. Every thread of the block constructs it, and calls flush() once
// at the end.
struct GroupAcc {
  int mode;
  int k;
  int cols;
  int pitch;
  unsigned long long* sacc;   // kWarpAcc: the block's (warps, k, pitch)
  unsigned long long* wacc;   // this warp's rows of sacc
  unsigned long long* acc;

  __device__ __forceinline__ GroupAcc(int mode_, int k_, int cols_,
                                      unsigned char* smem,
                                      unsigned long long* acc_)
      : mode(mode_),
        k(k_),
        cols(cols_),
        pitch(acc_pitch(cols_)),
        sacc(reinterpret_cast<unsigned long long*>(smem)),
        wacc(sacc + (size_t)(threadIdx.x >> 5) * k_ * acc_pitch(cols_)),
        acc(acc_) {
    if (mode == kWarpAcc) {
      for (int e = threadIdx.x & 31; e < k * pitch; e += 32) wacc[e] = 0ull;
      __syncwarp();
    }
  }

  // A group total v at column q of row `key` (0 adds nothing), from its
  // leader.
  __device__ __forceinline__ void put(int key, int q, unsigned long long v) {
    if (v == 0ull) return;
    if (mode == kWarpAcc) {
      wacc[key * pitch + q] += v;
    } else {
      atomicAdd(acc + (long long)key * cols + q, v);
    }
  }

  // kWarpAcc: the warps' rows summed, one global atomicAdd a non-zero
  // entry.
  __device__ __forceinline__ void flush() {
    if (mode != kWarpAcc) return;
    __syncthreads();
    const int warps = blockDim.x >> 5;
    for (int e = threadIdx.x; e < k * cols; e += blockDim.x) {
      const int j = e / cols;
      const int s = j * pitch + (e - j * cols);
      unsigned long long v = 0ull;
      for (int wp = 0; wp < warps; ++wp) {
        v += sacc[(size_t)wp * k * pitch + s];
      }
      if (v != 0ull) atomicAdd(acc + e, v);
    }
  }
};

// One point a lane: its terms w·x_q (q < d) at scale scx and w at scale
// scw, each rounded once to an int64, summed over the warp's lanes of the
// same key (WarpGroups) and put by each group's leader into row `key`
// (d + 1 entries, w last) of the accumulators; key < 0 adds nothing. The
// point is point p of r. All 32 lanes of the warp call this together.
template <typename T, int DR, int P>
__device__ __forceinline__ void put_point(const Rows<T, DR, P>& r, int p,
                                          int key, float wi, int d,
                                          double scx, double scw,
                                          GroupAcc& acc) {
  const WarpGroups g(key);
  const double wd = (double)wi;
  if (DR > 0) {
#pragma unroll
    for (int q0 = 0; q0 < DR; q0 += 8) {
      unsigned long long v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        v[i] = (key >= 0 && q0 + i < d)
                   ? to_fixed_scaled(wd * (double)r.xr[p][q0 + i], scx)
                   : 0ull;
      }
      g.sum(v);
      if (g.leader) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (q0 + i < d) acc.put(key, q0 + i, v[i]);
        }
      }
    }
  } else {
    for (int q = 0; q < d; ++q) {
      const double xq = (double)widen(r.row[p][q]);
      unsigned long long v[1] = {key >= 0 ? to_fixed_scaled(wd * xq, scx)
                                          : 0ull};
      g.sum(v);
      if (g.leader) acc.put(key, q, v[0]);
    }
  }
  unsigned long long vw[1] = {key >= 0 ? to_fixed_scaled(wd, scw) : 0ull};
  g.sum(vw);
  if (g.leader) acc.put(key, d, vw[0]);
}

// acc·2^-s as float32: out[j·d + q] = sums, out[k·d + j] = counts.
__device__ __forceinline__ void fixed_finalize(
    const unsigned long long* __restrict__ acc, long long k, int d,
    long long n, const unsigned* __restrict__ bound, float* __restrict__ out) {
  const Shifts s = shifts(bound, n);
  const long long total = k * (d + 1);
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long j = e / (d + 1);
    const int q = (int)(e - j * (d + 1));
    const double v = (double)(long long)acc[e];
    if (q < d) {
      out[j * d + q] = (float)ldexp(v, -s.x);
    } else {
      out[k * d + j] = (float)ldexp(v, -s.w);
    }
  }
}

// out[j·d + q] = sums, out[k·d + j] = counts, from the fixed-point rows.
__global__ void __launch_bounds__(kThreads)
    fixed_finalize_kernel(const unsigned long long* __restrict__ acc,
                          long long k, int d, long long n,
                          const unsigned* __restrict__ bound,
                          float* __restrict__ out) {
  fixed_finalize(acc, k, d, n, bound, out);
}

// The fixed-point rows to float32 (every block), and a cost: the per-tile
// partials summed in tile order (block 0) into out[k·d + k], the same
// bits on every run and for every grid. It may be launched after the
// kernel whose sums it reads (launch_ex; sensitivity_scores).
__global__ void __launch_bounds__(kThreads)
    fused_finalize_kernel(const unsigned long long* __restrict__ acc,
                          long long k, int d, long long n,
                          const unsigned* __restrict__ bound,
                          const float* __restrict__ part, long long tiles,
                          float* __restrict__ out) {
  wait_prerequisites();
  fixed_finalize(acc, k, d, n, bound, out);
  if (blockIdx.x == 0) {
    float a = 0.f;
    for (long long b = threadIdx.x; b < tiles; b += blockDim.x) a += part[b];
    const float s = block_sum(a);
    if (threadIdx.x == 0) out[k * d + k] = s;
  }
}

// The scratch of a walk with fixed-point sums (the Lloyd step; with
// d = 0, sensitivity_scores' masses), in bytes from its start: the
// wrapper allocates one buffer of `total` bytes (kernels/fused_lloyd.py::
// scratch_bytes mirrors it), and the first `zeroed` bytes are set to 0 by
// one memset: the (k, d + 1) int64 accumulators, the bound, the tile
// counters; then the tile cost partials, with more than one center slice
// the (slices, n) per-slice best and arg, and `assign_rows` int32 of
// argmin (the tiled Lloyd step's, read back by its column reduce).
struct Scratch {
  size_t acc, bound, done, zeroed, part, best, arg, assign, total;
};

inline Scratch scratch_layout(long long n, int d, int k, long long tiles,
                              int slices, long long assign_rows = 0) {
  Scratch s;
  s.acc = 0;
  s.bound = s.acc + (size_t)k * (d + 1) * 8;
  s.done = s.bound + 8;
  s.zeroed = s.done + round8((size_t)tiles * 4);
  s.part = s.zeroed;
  s.best = s.part + round8((size_t)tiles * 4);
  const size_t ws = slices > 1 ? round8((size_t)slices * n * 4) : 0;
  s.arg = s.best + ws;
  s.assign = s.arg + ws;
  s.total = s.assign + round8((size_t)assign_rows * 4);
  return s;
}

// A grid-stride launch over `items`, at most 4096 blocks.
inline unsigned grid_for(long long items) {
  const long long b = blocks_for(items);
  return (unsigned)(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

// Shared-memory tile shape for a given d and register row length DR.
struct TileShape {
  int kt;
  size_t smem;
};

inline TileShape tile_shape(int d, int dr, int k) {
  const int stride = dr > 0 ? dr : d;
  int kt = kTileFloats / (stride > 0 ? stride : 1);
  kt = kt < k ? kt : k;
  kt = kt > 1 ? kt : 1;
  return {kt, (size_t)kt * stride * sizeof(float) + (size_t)kt * 8};
}

// Calls f(T*{}, integral_constant<int, DR>{}) for the point dtype and the
// register row length that covers d: 16 for the paper's d = 15, else 0
// (any d).
template <typename T, typename F>
cudaError_t by_width(int d, F&& f) {
  if (d <= 16) return f((T*)nullptr, std::integral_constant<int, 16>());
  return f((T*)nullptr, std::integral_constant<int, 0>());
}

template <typename F>
cudaError_t dispatch(int dtype, int d, F&& f) {
  switch (dtype) {
    case kF32: return by_width<float>(d, f);
    case kBF16: return by_width<__nv_bfloat16>(d, f);
    case kF16: return by_width<__half>(d, f);
    default: return cudaErrorInvalidValue;
  }
}

// Raises `kern`'s dynamic shared-memory limit to `smem` where the default
// 48 KB is short, once a (kernel, device, size) and not every call.
template <typename... KArgs>
cudaError_t smem_limit(void (*kern)(KArgs...), size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, size_t> limits;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  size_t& limit = limits[std::make_pair(reinterpret_cast<const void*>(kern),
                                        dev)];
  if (smem <= limit) return cudaSuccess;
  const cudaError_t e2 = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e2 == cudaSuccess) limit = smem;
  return e2;
}

// Launch with dynamic shared memory (smem_limit first).
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kern)(KArgs...), dim3 grid, size_t smem,
                   cudaStream_t stream, Args... args) {
  const cudaError_t e = smem_limit(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// launch through cudaLaunchKernelEx; with `after`, as a programmatic
// dependent of the kernel before it on the stream, which `kern` waits for
// (wait_prerequisites) before it reads what that kernel writes. Only
// sensitivity_scores gains by it: its walk needs the pass over w only
// after its search (PERF.md §6 has the two kernels it slowed).
template <typename... KArgs, typename... Args>
cudaError_t launch_ex(bool after, void (*kern)(KArgs...), dim3 grid,
                      size_t smem, cudaStream_t stream, Args... args) {
  const cudaError_t e = smem_limit(kern, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = after ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

// The blocks of `kern` (kThreads threads, `smem` bytes of dynamic shared
// memory) an SM holds at once, at least 1, for a persistent grid, queried
// once a (kernel, device, size); smem_limit first.
template <typename... KArgs>
cudaError_t blocks_per_sm(void (*kern)(KArgs...), size_t smem, int* per_sm) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key =
      std::make_tuple(reinterpret_cast<const void*>(kern), dev, smem);
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto hit = cache.find(key);
    if (hit != cache.end()) {
      *per_sm = hit->second;
      return cudaSuccess;
    }
  }
  e = smem_limit(kern, smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  *per_sm = blocks > 0 ? blocks : 1;
  std::lock_guard<std::mutex> lock(mu);
  cache[key] = *per_sm;
  return cudaSuccess;
}

}  // namespace rt
