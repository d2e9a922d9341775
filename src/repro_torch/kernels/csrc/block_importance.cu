// Eq. 1 block losses for Hopper (sm_90a).
//
// Replaces repro/kernels/block_importance.py:34 block_importance_pallas
// (kernel _make_kernel, :21-28).  Same function:
//   L[i, j] = sum of rho(w) over the bm x bn block (i, j),
// with rho = |w| (l1) or w^2 (l2) computed in the weight's dtype, as the
// oracle does, and summed in f32.  Output (M/bm, N/bn) f32.  The work is
// one read of w and two operations per element, so device-memory bytes
// bound it; no tensor cores and no shared-memory staging are needed.
//
// The wrapper (block_importance.py, through plans.bi_plan) picks one
// variant before the launch:
//
// strip (bm = bn = 128, bf16 or f32, w 16-byte aligned).  Each warp sums
//   one block; a CTA of 4 warps covers a strip of 4 neighbouring column
//   blocks of one block row.  Every load is 16 bytes (8 bf16 or 4 f32):
//   16 (bf16) or 32 (f32) lanes cover a block row of 256 or 512 bytes, so
//   a warp reads 2 or 1 whole rows per instruction.  The block shape is a
//   compile-time constant, and each lane issues 8 independent loads before
//   it sums any (8 accumulators), so an SM holds tens of KB in flight.
//   Sums run in a fixed order (each load's values pairwise, the 8
//   accumulators pairwise, then a shuffle tree xor 16, 8, 4, 2, 1), so a
//   result is bitwise repeatable.
//
// general (any other block shape): one CTA of 256 threads per block (i, j),
//   neighbouring threads on neighbouring columns, each thread a private
//   f32 sum of element loads, reduced with warp shuffles and one
//   shared-memory pass.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float rho(float v, int criterion) {
  return criterion == 0 ? fabsf(v) : v * v;
}

__device__ __forceinline__ float rho(__nv_bfloat16 v, int criterion) {
  // rho in bf16 first (abs is exact; the square rounds to bf16), then f32
  const float f = __bfloat162float(v);
  return criterion == 0 ? fabsf(f) : __bfloat162float(__float2bfloat16(f * f));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
bi_kernel(const T* __restrict__ w, float* __restrict__ out, int M, int N, int bm, int bn,
          int criterion) {
  __shared__ float partial[THREADS / 32];
  const int bj = blockIdx.x, bi = blockIdx.y;
  const T* base = w + (size_t)bi * bm * N + (size_t)bj * bn;
  float acc = 0.f;
  for (int i = threadIdx.x; i < bm * bn; i += THREADS) {
    const int r = i / bn, c = i % bn;
    acc += rho(base[(size_t)r * N + c], criterion);
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    float s = threadIdx.x < THREADS / 32 ? partial[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (threadIdx.x == 0) out[(size_t)bi * (N / bn) + bj] = s;
  }
}

// rho summed over the 8 bf16 (or 4 f32) of one 16-byte load, pairwise.
template <int CRIT>
__device__ __forceinline__ float rho16(uint4 v, __nv_bfloat16) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  float r[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
    r[2 * i] = CRIT == 0 ? fabsf(f.x) : __bfloat162float(__float2bfloat16(f.x * f.x));
    r[2 * i + 1] = CRIT == 0 ? fabsf(f.y) : __bfloat162float(__float2bfloat16(f.y * f.y));
  }
  return ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
}

template <int CRIT>
__device__ __forceinline__ float rho16(uint4 v, float) {
  const float r[4] = {__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                      __uint_as_float(v.w)};
  if (CRIT == 0) return (fabsf(r[0]) + fabsf(r[1])) + (fabsf(r[2]) + fabsf(r[3]));
  return (r[0] * r[0] + r[1] * r[1]) + (r[2] * r[2] + r[3] * r[3]);
}

constexpr int STRIP_WARPS = 4;   // column blocks (one per warp) per CTA
constexpr int STRIP_LOADS = 8;   // independent 16-byte loads in flight per lane

template <typename T, int CRIT>
__global__ void __launch_bounds__(STRIP_WARPS * 32)
bi_strip_kernel(const T* __restrict__ w, float* __restrict__ out, int N) {
  constexpr int VEC = 16 / sizeof(T);       // elements per load
  constexpr int LPR = 128 / VEC;            // lanes per block row: 16 (bf16), 32 (f32)
  constexpr int RPS = 32 / LPR;             // block rows per warp load: 2, 1
  constexpr int STEPS = 128 / RPS;          // loads per lane: 64, 128
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = N / 128;
  const int bj = blockIdx.x * STRIP_WARPS + warp, bi = blockIdx.y;
  if (bj >= nb) return;                     // warp-uniform; no barrier follows
  const T* base = w + (static_cast<size_t>(bi) * 128 + lane / LPR) * N +
                  static_cast<size_t>(bj) * 128 + (lane % LPR) * VEC;
  float acc[STRIP_LOADS];
#pragma unroll
  for (int u = 0; u < STRIP_LOADS; ++u) acc[u] = 0.f;
#pragma unroll 1
  for (int s0 = 0; s0 < STEPS; s0 += STRIP_LOADS) {
    uint4 v[STRIP_LOADS];
#pragma unroll
    for (int u = 0; u < STRIP_LOADS; ++u)
      v[u] = __ldg(reinterpret_cast<const uint4*>(base + static_cast<size_t>(s0 + u) * RPS * N));
#pragma unroll
    for (int u = 0; u < STRIP_LOADS; ++u) acc[u] += rho16<CRIT>(v[u], T());
  }
  float a = ((acc[0] + acc[1]) + (acc[2] + acc[3])) + ((acc[4] + acc[5]) + (acc[6] + acc[7]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
  if (lane == 0) out[static_cast<size_t>(bi) * nb + bj] = a;
}

template <typename T>
int launch_strip(const void* w, void* out, int M, int N, int criterion, void* stream) {
  if (M % 128 || N % 128 || M <= 0 || N <= 0) return cudaErrorInvalidValue;
  dim3 grid((N / 128 + STRIP_WARPS - 1) / STRIP_WARPS, M / 128);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* wp = static_cast<const T*>(w);
  float* op = static_cast<float*>(out);
  if (criterion == 0) bi_strip_kernel<T, 0><<<grid, STRIP_WARPS * 32, 0, st>>>(wp, op, N);
  else bi_strip_kernel<T, 1><<<grid, STRIP_WARPS * 32, 0, st>>>(wp, op, N);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* w, void* out, int M, int N, int bm, int bn, int criterion,
           void* stream) {
  dim3 grid(N / bn, M / bm);
  bi_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(w), static_cast<float*>(out), M, N, bm, bn, criterion);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bi_bf16(const void* w, void* out, int M, int N, int bm, int bn, int criterion,
                       void* stream) {
  return launch<__nv_bfloat16>(w, out, M, N, bm, bn, criterion, stream);
}

extern "C" int bi_f32(const void* w, void* out, int M, int N, int bm, int bn, int criterion,
                      void* stream) {
  return launch<float>(w, out, M, N, bm, bn, criterion, stream);
}

// The strip variant: bm = bn = 128, w 16-byte aligned (M, N multiples of 128).
extern "C" int bi_bf16_strip(const void* w, void* out, int M, int N, int criterion,
                             void* stream) {
  return launch_strip<__nv_bfloat16>(w, out, M, N, criterion, stream);
}

extern "C" int bi_f32_strip(const void* w, void* out, int M, int N, int criterion,
                            void* stream) {
  return launch_strip<float>(w, out, M, N, criterion, stream);
}
