// Row-aligned IntraBlock (N:M) gather-matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/intrablock_matmul.py:41 intrablock_gather_matmul_pallas
// (kernel body _make_kernel._kernel, :24-37).  Same function:
//   y = x[:, row_idx] @ w_comp
// with f32 accumulation and one cast to the input dtype at the end.  The
// row gather stands in for the CIM mux that routes each compressed weight
// row its original input element.
//
// Layout: x (B, K), w_comp (Kc, N), row_idx (Kc,) int32 with
// 0 <= row_idx < K (the wrapper checks), y (B, N), all contiguous.
//
// bf16 path: one CTA (4 warps) per (TB-row tile of x, TN = 128-column tile
// of w_comp).  The CTA walks Kc in chunks of KC = 64 rows: it gathers
// x[rows, row_idx[k0:k0+KC]] into shared memory, stages the KC x TN weight
// chunk beside it, and accumulates with WMMA 16x16x16 bf16 tensor-core
// tiles in f32 registers.  Rows of x past B, columns of w_comp past N and
// chunk rows past Kc are zero-filled, so the caller pads nothing.  TB is
// 64 for prefill-sized B and 16 for decode.  Each thread issues all its
// loads of the next chunk into registers before the current chunk's WMMA
// work, so the memory latency of one chunk overlaps the compute of the
// other: a loop that loaded and stored one 16-byte piece at a time waits
// out the full latency eight times per chunk (about 7 us a chunk on an
// H100, where the weight bytes of a chunk need well under 1 us).
// The TPU kernel gathers the whole (TB, K) row tile of x into VMEM once and
// reuses it across the N tiles of a sequential grid; here CTAs run in
// parallel and share nothing, and a (64, K) tile does not fit in shared
// memory for the model's K, so each CTA gathers only the (TB, KC) slices
// its own chunks need (x is small next to w_comp on every main-path call).
//
// Bound: at decode (B = 4) the kernel streams w_comp once and does 2*B
// flops per weight, so device-memory bytes bound it.  Known limits of this
// first version: with TN = 128, wk/wv of qwen3-4b (N = 1024) give only 8
// CTAs on 132 SMs and wq (N = 4096) 32; the weight stream is not
// pipelined beyond the one register stage (no cp.async/TMA, no wgmma).
//
// f32 path: plain FMA in f32 (no TF32), one thread per output column and
// 8 rows of x per CTA.  It is the precision reference on the card.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int NWARP = 4;
constexpr int TN = 128;
constexpr int KC = 64;

template <int TB>
__global__ void __launch_bounds__(NWARP * 32)
igm_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                const int* __restrict__ ridx, __nv_bfloat16* __restrict__ y,
                int B, int K, int Kc, int N, bool wvec) {
  constexpr int NFN = TN / 16;                   // column fragments of a tile
  constexpr int NF = (TB / 16) * NFN;            // fragments of the CTA
  constexpr int FPW = NF / NWARP;                // fragments of a warp
  constexpr int STAGE = (TB * KC + KC * TN) * 2; // bytes: gathered x + weights
  constexpr int EPI = TB * TN * 4;               // bytes: f32 output tile
  constexpr int SMEM = STAGE > EPI ? STAGE : EPI;
  __shared__ __align__(128) unsigned char smem[SMEM];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem);   // TB x KC
  __nv_bfloat16* sW = sX + TB * KC;                              // KC x TN
  float* sY = reinterpret_cast<float*>(smem);                    // TB x TN (epilogue)

  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = blockIdx.x * TB, n0 = blockIdx.y * TN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FPW];
#pragma unroll
  for (int i = 0; i < FPW; ++i) wmma::fill_fragment(acc[i], 0.f);

  // Each thread stages fixed columns of a chunk: gathered column xc of x
  // for rows xr0 + j*XSTEP, and the 8 weight columns wc0..wc0+7 of rows
  // wr0 + j*WSTEP.  Its loads for chunk k0 + KC are issued into registers
  // before the WMMA work of chunk k0, so their latency overlaps it.
  constexpr int NT = NWARP * 32;
  constexpr int XV = TB * KC / NT, XSTEP = NT / KC;           // x values per thread
  constexpr int WV = KC * TN / 8 / NT, WSTEP = NT / (TN / 8);  // 16-byte weight loads
  const int xc = tid % KC, xr0 = tid / KC;
  const int wc0 = (tid % (TN / 8)) * 8, wr0 = tid / (TN / 8);
  __nv_bfloat16 xreg[XV];
  uint4 wreg[WV];

  auto load = [&](int k0) {
    const int kn = min(KC, Kc - k0);
    const int k = xc < kn ? __ldg(ridx + k0 + xc) : -1;
#pragma unroll
    for (int j = 0; j < XV; ++j) {
      const int r = row0 + xr0 + j * XSTEP;
      xreg[j] = (r < B && k >= 0) ? x[(size_t)r * K + k] : __float2bfloat16(0.f);
    }
    if (wvec) {   // N % 8 == 0 and w 16-byte aligned: 16-byte loads
#pragma unroll
      for (int j = 0; j < WV; ++j) {
        const int r = wr0 + j * WSTEP;
        wreg[j] = (r < kn && n0 + wc0 < N)
                      ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + wc0))
                      : make_uint4(0, 0, 0, 0);
      }
    }
  };

  load(0);
  for (int k0 = 0; k0 < Kc; k0 += KC) {
#pragma unroll
    for (int j = 0; j < XV; ++j) sX[(xr0 + j * XSTEP) * KC + xc] = xreg[j];
    if (wvec) {
#pragma unroll
      for (int j = 0; j < WV; ++j)
        *reinterpret_cast<uint4*>(sW + (wr0 + j * WSTEP) * TN + wc0) = wreg[j];
    } else {      // ragged or unaligned weights: scalar loads, not prefetched
      const int kn = min(KC, Kc - k0);
      for (int i = tid; i < KC * TN; i += NT) {
        const int r = i / TN, c = i % TN;
        sW[i] = (r < kn && n0 + c < N) ? w[(size_t)(k0 + r) * N + n0 + c]
                                       : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
    if (k0 + KC < Kc) load(k0 + KC);
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
#pragma unroll
      for (int i = 0; i < FPW; ++i) {
        const int f = warp + NWARP * i;
        const int mi = f / NFN, ni = f % NFN;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sX + mi * 16 * KC + kk, KC);
        wmma::load_matrix_sync(b, sW + kk * TN + ni * 16, TN);
        wmma::mma_sync(acc[i], a, b, acc[i]);
      }
    }
    __syncthreads();   // the next chunk (or the epilogue's sY) reuses smem
  }

#pragma unroll
  for (int i = 0; i < FPW; ++i) {
    const int f = warp + NWARP * i;
    const int mi = f / NFN, ni = f % NFN;
    wmma::store_matrix_sync(sY + mi * 16 * TN + ni * 16, acc[i], TN, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = tid; i < TB * TN; i += blockDim.x) {
    const int r = i / TN, c = i % TN;
    if (row0 + r < B && n0 + c < N)
      y[(size_t)(row0 + r) * N + n0 + c] = __float2bfloat16(sY[i]);
  }
}

constexpr int F32_ROWS = 8;
constexpr int F32_THREADS = 256;

__global__ void __launch_bounds__(F32_THREADS)
igm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ ridx, float* __restrict__ y,
               int B, int K, int Kc, int N) {
  const int row0 = blockIdx.x * F32_ROWS;
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= N) return;
  const int nr = min(F32_ROWS, B - row0);
  float acc[F32_ROWS];
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r) acc[r] = 0.f;
#pragma unroll 8
  for (int k = 0; k < Kc; ++k) {
    const int xk = __ldg(ridx + k);
    const float wv = w[(size_t)k * N + c];
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r)
      if (r < nr) acc[r] = fmaf(__ldg(x + (size_t)(row0 + r) * K + xk), wv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r)
    if (r < nr) y[(size_t)(row0 + r) * N + c] = acc[r];
}

}  // namespace

extern "C" int igm_bf16(const void* x, const void* w, const void* ridx, void* y, int B, int K,
                        int Kc, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return cudaSuccess;
  const bool wvec = N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* ib = static_cast<const int*>(ridx);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (B > 16) {
    dim3 grid((B + 63) / 64, (N + TN - 1) / TN);
    igm_bf16_kernel<64><<<grid, NWARP * 32, 0, st>>>(xb, wb, ib, yb, B, K, Kc, N, wvec);
  } else {
    dim3 grid(1, (N + TN - 1) / TN);
    igm_bf16_kernel<16><<<grid, NWARP * 32, 0, st>>>(xb, wb, ib, yb, B, K, Kc, N, wvec);
  }
  return cudaGetLastError();
}

extern "C" int igm_f32(const void* x, const void* w, const void* ridx, void* y, int B, int K,
                       int Kc, int N, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || N <= 0) return cudaSuccess;
  dim3 grid((B + F32_ROWS - 1) / F32_ROWS, (N + F32_THREADS - 1) / F32_THREADS);
  igm_f32_kernel<<<grid, F32_THREADS, 0, st>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w),
                                               static_cast<const int*>(ridx),
                                               static_cast<float*>(y), B, K, Kc, N);
  return cudaGetLastError();
}
