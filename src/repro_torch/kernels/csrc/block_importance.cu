// Eq. 1 block losses for Hopper (sm_90a).
//
// Replaces repro/kernels/block_importance.py:34 block_importance_pallas
// (kernel _make_kernel, :21-28).  Same function:
//   L[i, j] = sum of rho(w) over the bm x bn block (i, j),
// with rho = |w| (l1) or w^2 (l2) computed in the weight's dtype, as the
// oracle does, and summed in f32.  Output (M/bm, N/bn) f32.
//
// One CTA of 256 threads per block (i, j): neighbouring threads read
// neighbouring columns, each thread keeps a private f32 sum, and the CTA
// reduces with warp shuffles and one shared-memory pass.  The work is one
// read of w and two operations per element, so device-memory bytes bound
// it; no tensor cores and no shared-memory staging are needed.
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
