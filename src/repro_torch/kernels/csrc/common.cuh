// Shared device code of the port's clustering kernels (sm_90a).
//
// Every kernel here answers "which valid center is nearest to this point",
// with the center set streamed through shared memory in tiles, in one of
// two walks of the same per-point arithmetic (bit for bit):
//   nearest          one point a thread: sensitivity_scores,
//                    truncated_cost;
//   nearest_split    P points a thread (nearest_blocked), the center axis
//                    optionally split over blocks: the Lloyd step
//                    (fused_assign.cu), min_dist and remove_below.
// The seeding step (fused_lloyd.cu::seed_step_kernel) walks nearest()'s
// arithmetic too, one point a thread, on rows staged in shared memory.
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

#include <type_traits>

namespace rt {

constexpr int kThreads = 256;        // threads a block
constexpr int kTileFloats = 8192;    // 32 KB of centers per shared tile

enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

__device__ __forceinline__ float clamp0(float v) {
  return v < 0.f ? 0.f : v;          // NaN passes through, as in torch.clamp
}

// Nearest valid center of one point against all k centers.
//
// DR > 0: the point's row lives in DR registers (zero-padded past d) and
// center rows are stored DR floats apart, read as float4 broadcasts.
// DR == 0: any d; the row is re-read from global memory (L1-resident)
// for each center. Every thread of the block must call this (it holds
// __syncthreads); `active` is false for the ragged tail past n.
//
// Ties keep the first index (strict <), as jnp.argmin and torch.min do.
// With no valid center, best stays +inf and arg 0, as in the reference.
template <typename T, int DR>
__device__ __forceinline__ void nearest(
    const T* __restrict__ xrow, bool active, int d,
    const float* __restrict__ c, const uint8_t* __restrict__ cv, int k,
    int kt, float* smem, float& best, int& arg, float& x2, bool& any_valid) {
  constexpr int kRegs = DR > 0 ? DR : 1;
  const int stride = DR > 0 ? DR : d;
  float* sc = smem;                            // (kt, stride) center rows
  float* sc2 = sc + (size_t)kt * stride;       // (kt,) ||c||^2
  int* sok = reinterpret_cast<int*>(sc2 + kt);  // (kt,) validity

  float xr[kRegs];
  x2 = 0.f;
  if (DR > 0) {
#pragma unroll
    for (int q = 0; q < kRegs; ++q) {
      xr[q] = (active && q < d) ? widen(xrow[q]) : 0.f;
      x2 = fmaf(xr[q], xr[q], x2);
    }
  } else if (active) {
    for (int q = 0; q < d; ++q) {
      const float v = widen(xrow[q]);
      x2 = fmaf(v, v, x2);
    }
  }

  best = INFINITY;
  arg = 0;
  any_valid = false;
  for (int t0 = 0; t0 < k; t0 += kt) {
    const int rows = min(kt, k - t0);
    __syncthreads();                           // last tile fully consumed
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
      sc2[j] = s;
      sok[j] = cv == nullptr ? 1 : (int)cv[t0 + j];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < rows; ++j) {
      if (!sok[j]) continue;
      any_valid = true;
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
        for (int q = 0; q < d; ++q) dot = fmaf(widen(xrow[q]), cr[q], dot);
      }
      const float t = fmaf(-2.f, dot, sc2[j]);
      if (t < best) {
        best = t;
        arg = t0 + j;
      }
    }
  }
}

// ------------------------------------------- register-blocked center walk
// nearest() for P points a thread: each center row read from shared
// memory feeds P·DR FMAs instead of DR, and its validity and ||c||^2 are
// read once for the P points. Per point the arithmetic is nearest()'s to
// the bit: the same fmaf chain over q = 0 .. DR-1 (or 0 .. d-1), the same
// t = fmaf(-2, dot, ||c||^2) with ||c||^2 from the same loop, a strict <
// over ascending j, and (+inf, 0) with no valid center. So the argmin and
// min-d2 equal those of the kernels still on nearest().
//
// Rows<T, DR, P> holds the thread's P points: their rows in registers
// (DR > 0, zero-padded past d) or their row pointers (DR == 0, any d,
// re-read from L1), and ||x||^2 computed as nearest() computes it. Point p
// of the thread is row first + p·blockDim.x; a row past n is inactive and
// reads row 0.
template <typename T, int DR, int P>
struct Rows {
  static constexpr int kRegs = DR > 0 ? DR : 1;
  const T* row[P];
  long long idx[P];
  bool active[P];
  float xr[P][kRegs];
  float x2[P];

  __device__ __forceinline__ Rows(const T* __restrict__ x, long long n,
                                  int d, long long first) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      idx[p] = first + (long long)p * blockDim.x;
      active[p] = idx[p] < n;
      row[p] = x + (active[p] ? idx[p] : 0) * d;
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

// The nearest valid center among [j_lo, j_hi) of each of the thread's P
// points (absolute indices in arg). Every thread of the block must call
// this (it holds __syncthreads). The shared tile is nearest()'s: kt rows
// of `stride` floats (DR, or d), then kt ||c||^2.
//
// An invalid center's ||c||^2 is +inf: its t is +inf (or NaN), never
// < best, so it is never chosen, and a valid center's t is computed as
// nearest() computes it: no validity array and no branch in the walk.
template <typename T, int DR, int P>
__device__ __forceinline__ void nearest_blocked(
    const Rows<T, DR, P>& r, int d, const float* __restrict__ c,
    const uint8_t* __restrict__ cv, int j_lo, int j_hi, int kt, float* smem,
    float (&best)[P], int (&arg)[P]) {
  const int stride = DR > 0 ? DR : d;
  float* sc = smem;                            // (kt, stride) center rows
  float* sc2 = sc + (size_t)kt * stride;       // (kt,) ||c||^2, or +inf
  bool any_active = false;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    best[p] = INFINITY;
    arg[p] = 0;
    any_active |= r.active[p];
  }
  for (int t0 = j_lo; t0 < j_hi; t0 += kt) {
    const int rows = min(kt, j_hi - t0);
    __syncthreads();                           // last tile fully consumed
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
    if (!any_active) continue;
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
          arg[p] = t0 + j;
        }
      }
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
// block must call this.
template <typename T, int DR, int P>
__device__ __forceinline__ bool nearest_split(
    const Rows<T, DR, P>& r, long long n, int d, const float* __restrict__ c,
    const uint8_t* __restrict__ cv, int k, int slice, int s, int slices,
    long long tile, int kt, float* smem, unsigned* __restrict__ tile_done,
    float* __restrict__ ws_best, int* __restrict__ ws_arg,
    float (&best)[P], int (&arg)[P]) {
  const int j_lo = min(k, s * slice);
  const int j_hi = min(k, j_lo + slice);
  nearest_blocked<T, DR, P>(r, d, c, cv, j_lo, j_hi, kt, smem, best, arg);
  if (slices == 1) return true;
  const long long off = (long long)s * n;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (r.active[p]) {
      ws_best[off + r.idx[p]] = best[p];
      ws_arg[off + r.idx[p]] = arg[p];
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
        arg[p] = __ldcg(ws_arg + (long long)q * n + r.idx[p]);
      }
    }
  }
  return true;
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

// ------------------------------------------------ per-block center sums
// One block's weighted (k, d) sums (when `sums`) and (k,) weight counts,
// from its `rows` points' centers sa[] and weights sw[] in shared memory
// (a center outside [0, k) adds nothing). Thread q owns the (center,
// coordinate) pairs q, q + blockDim.x, ... and scans the block's points
// in order, so every per-block sum is taken in one fixed order. The sums
// go to part rows [0, k·d), the counts to rows [k·d, k·d + k) (to rows
// [0, k) when !sums), each row nb floats long, one per block; the
// fixed-order reduce_rows pass then adds each row in block order. Every
// thread of the block must call this after sa[] and sw[] are written and
// synchronized.
template <typename T>
__device__ __forceinline__ void center_partials(
    const T* __restrict__ x, long long base, int rows, int d, int k,
    const int* sa, const float* sw, bool sums, float* __restrict__ part,
    long long nb) {
  const int kd = sums ? k * d : 0;
  for (int q = threadIdx.x; q < kd; q += blockDim.x) {
    const int j = q / d;
    const int dd = q - j * d;
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) {
      if (sa[r] == j) acc = fmaf(sw[r], widen(x[(base + r) * d + dd]), acc);
    }
    part[(long long)q * nb + blockIdx.x] = acc;
  }
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float acc = 0.f;
    for (int r = 0; r < rows; ++r) {
      if (sa[r] == j) acc += sw[r];
    }
    part[(long long)(kd + j) * nb + blockIdx.x] = acc;
  }
}

// ------------------------------------------ fixed-point center sums
// Exact sums at every k for the Lloyd step (fused_assign.cu), and for
// lloyd_reduce beyond its per-block partials' limit: each term w·x_q is formed exactly in
// double, scaled by 2^s and rounded once to an int64, and added into its
// center's (d + 1)-wide accumulator row with an integer atomicAdd; the
// last column takes w at its own scale. s is the largest shift with
// n·max|w|·max|x|·2^s < 2^62, so no center's sum can overflow. Integer
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
  // contiguously, one a thread at a time.
  __shared__ float sw[kThreads];
  float mw = 0.f, mx = 0.f;
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
    for (int e = threadIdx.x; e < rows * d; e += kThreads) {
      if (sw[e / d] != 0.f) mx = fmaxf(mx, fabsf(widen(xb[e])));
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

__device__ __forceinline__ unsigned long long to_fixed(double v, int s) {
  return (unsigned long long)llrint(ldexp(v, s));   // two's complement
}

// Adds w·x and w of one point into its center's accumulator row.
template <typename T>
__device__ __forceinline__ void add_fixed(unsigned long long* row,
                                          const T* __restrict__ xrow, int d,
                                          float wi, Shifts s) {
  for (int q = 0; q < d; ++q) {
    atomicAdd(row + q, to_fixed((double)wi * (double)widen(xrow[q]), s.x));
  }
  atomicAdd(row + d, to_fixed((double)wi, s.w));
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

// Calls f(T*{}) for the point dtype alone (kernels with no center walk).
template <typename F>
cudaError_t by_dtype(int dtype, F&& f) {
  switch (dtype) {
    case kF32: return f((float*)nullptr);
    case kBF16: return f((__nv_bfloat16*)nullptr);
    case kF16: return f((__half*)nullptr);
    default: return cudaErrorInvalidValue;
  }
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

// Launch with dynamic shared memory, raising the per-kernel limit first
// when a tile needs more than the default 48 KB.
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kern)(KArgs...), dim3 grid, size_t smem,
                   cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace rt
