// fused_assign_reduce for center sets beyond the resident limit (k > 1024):
// one Lloyd step over any number of centers. Returns the (k, d) weighted
// sums, the (k,) weight counts and the weighted cost, as the resident
// kernel in fused_lloyd.cu does.
//
// Replaces repro/kernels/fused_lloyd.py::fused_assign_reduce_chunked_pallas
// (pallas_call at fused_lloyd.py:593) and its two-walk fallback
// _fused_assign_reduce_chunked_twopass (pallas_calls at :688 and :709). On
// the TPU the two differ only in where the (kp, d) accumulators live: in
// VMEM for the whole walk when they fit in 6 MiB (_CHUNK_ACC_BUDGET), else
// one center chunk at a time over a second walk of x. Here one design
// serves both regimes: the accumulators live in device memory, so their
// size sets no limit, and x is read once.
//
// Why the resident kernel's reduction does not carry over: its per-block
// partials are (k·d + k + 1)·ceil(n/256) floats, about 1 GB at 3,081
// centers and 1.25 M points (k-means‖ at k = 100) and about 43 GB at
// 173,256 centers (EIM11). Float atomicAdd into (k, d) would keep the
// scratch small but give other bits on every run: float addition is not
// associative, and atomics land in no fixed order.
//
// Design, fixed-point accumulation (chosen over a counting sort by center,
// which needs an (n,) assignment, a scan and a placement pass, because it
// is one sweep of x with scratch of (k, d + 1) int64 alone):
//   1. bound_kernel: max |w| and max |x| over the weighted points, by
//      atomicMax on the bit patterns of non-negative floats (exact in any
//      order).
//   2. chunked_assign_reduce_kernel: the nearest valid center of each
//      point (common.cuh: the center set streams through shared memory in
//      tiles with a running (min, argmin), the walk the TPU kernel makes
//      over center chunks). Each term w·x_q is formed exactly in double,
//      scaled by 2^s and rounded once to an int64, and added into the
//      point's (k, d + 1) accumulator row with an integer atomicAdd; the
//      last column takes w at its own scale. s is the largest shift with
//      n·max|w|·max|x|·2^s < 2^62, so no center's sum can overflow.
//      Integer addition is exact and associative: the accumulators hold
//      the same bits whatever order the blocks run in.
//   3. chunked_finalize_kernel: acc·2^-s, converted to float32.
// Each term's rounding error is at most 2^-(s+1), i.e. about
// n·max|w|·max|x|·2^-63: far below float32's own resolution of the sums.
// The cost keeps the per-block partials and the fixed-order reduce_rows
// pass of the resident kernel (one float per block). Zero-weight points
// add nothing (their terms are exactly 0), so they skip the atomics.
//
// Bound: the assignment is 2·n·k·d float32 operations on n·d inputs, at
// thousands of operations per byte of points, so it is bound by float32
// operations (k-means‖ at k = 100: 1.25 M points × ~3 k centers, ~1 ms at
// 67 TFLOP/s per machine); the atomics add n·(d + 1) integer additions
// spread over k rows.
#include "common.cuh"

namespace rt {

// bound[0] = max |w_i|, bound[1] = max |x_iq| over rows with w_i != 0, as
// float bits; the caller zeroes both. Finite inputs are assumed: NaN is
// skipped by fmaxf, an infinity makes the shift meaningless.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bound_kernel(const T* __restrict__ x, long long n, int d,
                 const float* __restrict__ w, unsigned* __restrict__ bound) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float mw = 0.f, mx = 0.f;
  for (long long i = first; i < n; i += stride) mw = fmaxf(mw, fabsf(w[i]));
  for (long long e = first; e < n * d; e += stride) {
    if (w[e / d] != 0.f) mx = fmaxf(mx, fabsf(widen(x[e])));
  }
  for (int o = 16; o > 0; o >>= 1) {
    mw = fmaxf(mw, __shfl_down_sync(0xffffffffu, mw, o));
    mx = fmaxf(mx, __shfl_down_sync(0xffffffffu, mx, o));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(bound, __float_as_uint(mw));
    atomicMax(bound + 1, __float_as_uint(mx));
  }
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

template <typename T, int DR>
__global__ void __launch_bounds__(kThreads)
    chunked_assign_reduce_kernel(const T* __restrict__ x, long long n, int d,
                                 const float* __restrict__ w,
                                 const float* __restrict__ c,
                                 const uint8_t* __restrict__ cv, int k,
                                 int kt, const unsigned* __restrict__ bound,
                                 unsigned long long* __restrict__ acc,
                                 float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n;
  const T* xrow = x + (active ? i : 0) * d;
  float best, x2;
  int arg;
  bool any_valid;
  nearest<T, DR>(xrow, active, d, c, cv, k, kt, smem, best, arg, x2,
                 any_valid);
  float cost = 0.f;
  if (active) {
    const float wi = w[i];
    cost = wi * clamp0(best + x2);
    if (wi != 0.f) {
      const Shifts s = shifts(bound, n);
      unsigned long long* row = acc + (long long)arg * (d + 1);
      for (int q = 0; q < d; ++q) {
        atomicAdd(row + q, to_fixed((double)wi * (double)widen(xrow[q]), s.x));
      }
      atomicAdd(row + d, to_fixed((double)wi, s.w));
    }
  }
  const float s = block_sum(cost);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// out[j·d + q] = sums, out[k·d + j] = counts, from the fixed-point rows.
__global__ void __launch_bounds__(kThreads)
    chunked_finalize_kernel(const unsigned long long* __restrict__ acc,
                            long long k, int d, long long n,
                            const unsigned* __restrict__ bound,
                            float* __restrict__ out) {
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

inline unsigned grid_for(long long items) {
  const long long b = blocks_for(items);
  return (unsigned)(b < 1 ? 1 : (b > 4096 ? 4096 : b));
}

}  // namespace rt

// bound holds 2 uint32, acc k*(d+1) int64, part max(blocks_for(n), 1)
// floats; out holds k*d + k + 1 floats: the (k, d) sums, the (k,) counts,
// then the cost.
extern "C" int rt_fused_assign_reduce_chunked(
    const void* x, int dtype, long long n, int d, const float* w,
    const float* c, const uint8_t* cv, int k, unsigned* bound,
    unsigned long long* acc, float* part, float* out, void* stream) {
  using namespace rt;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(bound, 0, 2 * sizeof(unsigned), s);
  if (e != cudaSuccess) return (int)e;
  e = cudaMemsetAsync(acc, 0, sizeof(unsigned long long) * (size_t)k * (d + 1),
                      s);
  if (e != cudaSuccess) return (int)e;
  const long long nb = blocks_for(n);
  e = dispatch(dtype, d, [&](auto tag, auto dr) -> cudaError_t {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int DR = decltype(dr)::value;
    if (n == 0) return cudaGetLastError();
    bound_kernel<T><<<grid_for(n * d), kThreads, 0, s>>>((const T*)x, n, d, w,
                                                        bound);
    const cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return e1;
    const TileShape ts = tile_shape(d, DR, k);
    return launch(chunked_assign_reduce_kernel<T, DR>, dim3((unsigned)nb),
                  ts.smem, s, (const T*)x, n, d, w, c, cv, k, ts.kt,
                  (const unsigned*)bound, acc, part);
  });
  if (e != cudaSuccess) return (int)e;
  chunked_finalize_kernel<<<grid_for((long long)k * (d + 1)), kThreads, 0,
                            s>>>(acc, k, d, n, bound, out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)reduce_rows(part, nb, 1, out + (long long)k * d + k, s);
}
