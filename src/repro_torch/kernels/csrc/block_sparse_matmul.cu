// FullBlock block-sparse matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/block_sparse_matmul.py:49 block_sparse_matmul_pallas
// (kernel body _kernel, :31-45).  Same function:
//   y[:, j*bn:(j+1)*bn] = sum_l x[:, idx[j,l]*bm : +bm] @ w_comp[j, l]
// with f32 accumulation and one cast to the input dtype at the end.  A
// slot with idx == -1 adds nothing wherever it sits in the list, so the
// kernel skips it (it does not stop at the first -1).
//
// Layout: x (B, K), w_comp (Gn, L, bm, bn), idx (Gn, L) int32, y (B, Gn*bn),
// all contiguous.
//
// bf16 path: one CTA (4 warps) per (TB-row tile of x, column group j).
// The CTA reads its own idx row and, for each live slot, stages the
// TB x bm slice of x and the bm x bn weight block in shared memory, then
// accumulates with WMMA 16x16x16 bf16 tensor-core tiles in f32
// registers.  Rows of x past B are zero-filled, so B needs no padding.
// TB is 64 for prefill-sized B and 16 for decode.
// Bound: at decode (B = 4) the kernel streams the live weight blocks
// once and does 2*B flops per weight, so device-memory bytes bound it.
// With a column group per CTA, wq (Gn = 32) launches only 32 CTAs on 132
// SMs: a known limit of this first version, as is the missing
// cp.async/TMA pipelining of the weight stream.
//
// f32 path: plain FMA in f32 (no TF32), one thread per output column
// and 8 rows per CTA.  It is the precision reference on the card.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int NWARP = 4;
constexpr int MAXF = 8;     // accumulator tiles per warp

template <int TB>
__global__ void __launch_bounds__(NWARP * 32)
bsm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const int* __restrict__ idx, __nv_bfloat16* __restrict__ y,
                int B, int K, int Gn, int L, int bm, int bn) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem);   // TB x bm
  __nv_bfloat16* sW = sX + TB * bm;                              // bm x bn
  float* sY = reinterpret_cast<float*>(smem);                    // TB x bn (epilogue)

  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = blockIdx.x * TB, j = blockIdx.y;
  const int nfn = bn / 16;
  const int nf = (TB / 16) * nfn;
  const int N = Gn * bn;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXF];
#pragma unroll
  for (int i = 0; i < MAXF; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int l = 0; l < L; ++l) {
    const int kb = idx[j * L + l];
    if (kb < 0) continue;          // padding slot: same value for the whole CTA
    const int xch = bm / 8;
    for (int i = tid; i < TB * xch; i += blockDim.x) {
      const int r = i / xch, c = (i % xch) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (row0 + r < B)
        val = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * K + (size_t)kb * bm + c);
      *reinterpret_cast<uint4*>(sX + r * bm + c) = val;
    }
    const __nv_bfloat16* wb = w + ((size_t)j * L + l) * bm * bn;
    for (int i = tid; i < bm * bn / 8; i += blockDim.x)
      *reinterpret_cast<uint4*>(sW + i * 8) = *reinterpret_cast<const uint4*>(wb + (size_t)i * 8);
    __syncthreads();
    for (int kk = 0; kk < bm; kk += 16) {
#pragma unroll
      for (int i = 0; i < MAXF; ++i) {
        const int f = warp + NWARP * i;
        if (f < nf) {
          const int mi = f / nfn, ni = f % nfn;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;
          wmma::load_matrix_sync(a, sX + mi * 16 * bm + kk, bm);
          wmma::load_matrix_sync(bf, sW + kk * bn + ni * 16, bn);
          wmma::mma_sync(acc[i], a, bf, acc[i]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MAXF; ++i) {
    const int f = warp + NWARP * i;
    if (f < nf) {
      const int mi = f / nfn, ni = f % nfn;
      wmma::store_matrix_sync(sY + mi * 16 * bn + ni * 16, acc[i], bn, wmma::mem_row_major);
    }
  }
  __syncthreads();
  for (int i = tid; i < TB * bn; i += blockDim.x) {
    const int r = i / bn, c = i % bn;
    if (row0 + r < B) y[(size_t)(row0 + r) * N + (size_t)j * bn + c] = __float2bfloat16(sY[i]);
  }
}

constexpr int F32_ROWS = 8;

__global__ void bsm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                               const int* __restrict__ idx, float* __restrict__ y,
                               int B, int K, int Gn, int L, int bm, int bn) {
  const int row0 = blockIdx.x * F32_ROWS, j = blockIdx.y;
  const int N = Gn * bn;
  for (int c = threadIdx.x; c < bn; c += blockDim.x) {
    float acc[F32_ROWS];
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r) acc[r] = 0.f;
    for (int l = 0; l < L; ++l) {
      const int kb = idx[j * L + l];
      if (kb < 0) continue;
      const float* wb = w + ((size_t)j * L + l) * bm * bn + c;
      const float* xb = x + (size_t)kb * bm;
      float part[F32_ROWS];
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) part[r] = 0.f;
      for (int t = 0; t < bm; ++t) {
        const float wv = wb[(size_t)t * bn];
#pragma unroll
        for (int r = 0; r < F32_ROWS; ++r)
          if (row0 + r < B) part[r] = fmaf(xb[(size_t)(row0 + r) * K + t], wv, part[r]);
      }
#pragma unroll
      for (int r = 0; r < F32_ROWS; ++r) acc[r] += part[r];
    }
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r)
      if (row0 + r < B) y[(size_t)(row0 + r) * N + (size_t)j * bn + c] = acc[r];
  }
}

template <int TB>
cudaError_t launch_bf16(const void* x, const void* w, const void* idx, void* y, int B, int K,
                        int Gn, int L, int bm, int bn, cudaStream_t st) {
  const size_t stage = (size_t)(TB * bm + bm * bn) * sizeof(__nv_bfloat16);
  const size_t epi = (size_t)TB * bn * sizeof(float);
  const size_t smem = stage > epi ? stage : epi;
  cudaError_t e = cudaFuncSetAttribute(bsm_bf16_kernel<TB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((B + TB - 1) / TB, Gn);
  bsm_bf16_kernel<TB><<<grid, NWARP * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(idx), static_cast<__nv_bfloat16*>(y), B, K, Gn, L, bm, bn);
  return cudaGetLastError();
}

}  // namespace

// Requires bm % 16 == 0, bn % 16 == 0 and (TB/16)*(bn/16) <= 32 for the
// chosen TB; the wrapper checks and picks TB (64 needs bn <= 128).
extern "C" int bsm_bf16(const void* x, const void* w, const void* idx, void* y, int B, int K,
                        int Gn, int L, int bm, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm % 16 || bn % 16) return cudaErrorInvalidValue;
  if (B > 16 && bn <= 128) return launch_bf16<64>(x, w, idx, y, B, K, Gn, L, bm, bn, st);
  if (bn > 512) return cudaErrorInvalidValue;
  return launch_bf16<16>(x, w, idx, y, B, K, Gn, L, bm, bn, st);
}

extern "C" int bsm_f32(const void* x, const void* w, const void* idx, void* y, int B, int K,
                       int Gn, int L, int bm, int bn, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((B + F32_ROWS - 1) / F32_ROWS, Gn);
  const int threads = bn < 256 ? ((bn + 31) / 32) * 32 : 256;
  bsm_f32_kernel<<<grid, threads, 0, st>>>(static_cast<const float*>(x),
                                           static_cast<const float*>(w),
                                           static_cast<const int*>(idx), static_cast<float*>(y),
                                           B, K, Gn, L, bm, bn);
  return cudaGetLastError();
}
