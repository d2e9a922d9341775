// Row-aligned IntraBlock (N:M) gather-matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/intrablock_matmul.py:41 intrablock_gather_matmul_pallas
// (kernel body _make_kernel._kernel, :24-37).  Same function:
//   y = x[:, row_idx] @ w_comp
// with f32 accumulation and one cast to the input dtype at the end.  The
// row gather stands in for the CIM mux that routes each compressed weight
// row its original input element.
//
// Layout: x (B, K), w_comp (Kc, N) with row stride ldw >= N elements,
// row_idx (Kc,) int32 with 0 <= row_idx < K (the wrapper checks), y (B, N);
// x, row_idx and y contiguous.  A weight whose rows a tensor map cannot
// describe (N % 8 != 0: rows of 2N bytes) is stored by sparsity/apply.py
// with its rows padded to a multiple of 8 elements, so ldw = N rounded up.
//
// The wrapper (intrablock_matmul.py, through plans.igm_plan) picks one
// variant before the launch, by dtype, B, the row stride and the
// alignment of w_comp:
//
// decode (bf16, B <= 16, 2*ldw % 16 == 0, w_comp 16-byte aligned; any N).
//   Bound: bytes (2*B flops per weight read).  Design: grid (c,
//   ceil(N/128)) in clusters of c CTAs, one cluster per 128-column tile
//   (the last one ragged: its columns past N arrive as zeros from the
//   tensor map and are not stored); CTA rank r takes
//   the 64-row chunks [r*n/c, (r+1)*n/c) of the n = ceil(Kc/64) chunks of
//   Kc (plans.split_range).  A producer warp fills a 4-stage ring: a
//   chunk's 64 x 128 weights arrive by two TMA loads of 64 x 64 boxes with
//   the 128-byte swizzle (rows past Kc arrive as zeros), from a tensor map
//   encoded once per weight address and then kept (sm90::cached_map): no
//   host work per decode call, where a qwen3-4b decode step runs this
//   kernel 216 times and its host already issues 98% of the step.  The
//   four consumer warps gather each chunk's (16, 64) slice of x together
//   (rows past B and columns past Kc zero; x is ~20 KB at decode and sits
//   in L2) into rows padded to 144 bytes, loading chunk s+1's values
//   while they compute chunk s, then run mma.sync m16n8k16, 32 columns
//   each.  The gather stays off the producer, whose weight loads run the
//   whole ring ahead: a producer that also gathered held the ring to one
//   chunk per L2 round trip.  The cluster sums its f32 partials through
//   distributed shared memory in rank order (sm90::cluster_reduce_store):
//   one launch, no atomics, bitwise repeatable.  Not one bulk copy per
//   256-byte weight row, which would need no tensor map: 64 copies a chunk
//   ran at 2-16% of the byte bound on an H100.
//   Sizing: ~25-50 KB must be in flight per SM (3.35 TB/s x 1-2 us over
//   132 SMs).  A stage holds 16 KB of weights and 2.3 KB of x; 4 stages
//   make a CTA of 75 KB, so two or three CTAs fit on an SM, up to 12
//   chunks (192 KB) in flight.  c is the smallest power of two (<= 8) that
//   brings the grid to 2 x 132 CTAs while each CTA keeps at least one
//   chunk: qwen3-4b wq 8 (256 CTAs), wk/wv 8 (64), w_gate/w_up 4 (304),
//   w_down 8 (160).
//
// prefill (bf16, B > 16, the same weights as decode).  Two launches: a
//   gather kernel writes x[:, row_idx] once into a (B, Kp) scratch buffer
//   (Kp = Kc rounded up to 8, the wrapper allocates it), then
//   sm90::gemm_prefill<1> multiplies it with the dense (Kc, N) weight: two
//   wgmma m64n128k16 warpgroups per 128 x 128 tile, a 3-stage ring of TMA
//   tensor-map loads (128-byte swizzle, B operand MN-major, maps from
//   sm90::cached_map), split-K over a cluster where the grid is small.
//   The gather is done once per call rather than in the producer warp
//   because every 128-column tile and every split of one row tile reads
//   the same gathered x: at B = 512 the gathered x (up to 5 MB) is read
//   20-76 times, and a dense TMA box cannot gather.  A second launch at
//   prefill costs a few microseconds against the 0.02-0.07 ms of the
//   product.  Its epilogue stores only the N - 128j columns of a ragged
//   last tile.
//
// general (bf16, any row stride, any alignment): one CTA (4 warps) per
//   (TB-row tile, 128-column tile), Kc walked in 64-row chunks with the
//   next chunk prefetched into registers, WMMA 16x16x16; a row stride
//   that is no multiple of 8 or an unaligned w_comp takes scalar weight
//   loads.
//
// f32 (igm_f32): plain FMA in f32 (no TF32), one thread per output column
//   and 8 rows of x per CTA.  It is the precision reference on the card.
#include "sm90_common.cu"
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
                int B, int K, int Kc, int N, int ldw, bool wvec) {
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
    if (wvec) {   // ldw % 8 == 0 and w 16-byte aligned: 16-byte loads
#pragma unroll
      for (int j = 0; j < WV; ++j) {
        const int r = wr0 + j * WSTEP;
        wreg[j] = (r < kn && n0 + wc0 < N)
                      ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * ldw + n0 + wc0))
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
        sW[i] = (r < kn && n0 + c < N) ? w[(size_t)(k0 + r) * ldw + n0 + c]
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
               int B, int K, int Kc, int N, int ldw) {
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
    const float wv = w[(size_t)k * ldw + c];
#pragma unroll
    for (int r = 0; r < F32_ROWS; ++r)
      if (r < nr) acc[r] = fmaf(__ldg(x + (size_t)(row0 + r) * K + xk), wv, acc[r]);
  }
#pragma unroll
  for (int r = 0; r < F32_ROWS; ++r)
    if (r < nr) y[(size_t)(row0 + r) * N + c] = acc[r];
}

}  // namespace

// General variant: any N, any row stride ldw >= N, any alignment of w, any B.
extern "C" int igm_bf16_general(const void* x, const void* w, const void* ridx, void* y, int B,
                                int K, int Kc, int N, int ldw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ldw < N) return cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return cudaSuccess;
  const bool wvec = ldw % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const auto* ib = static_cast<const int*>(ridx);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  if (B > 16) {
    dim3 grid((B + 63) / 64, (N + TN - 1) / TN);
    igm_bf16_kernel<64><<<grid, NWARP * 32, 0, st>>>(xb, wb, ib, yb, B, K, Kc, N, ldw, wvec);
  } else {
    dim3 grid(1, (N + TN - 1) / TN);
    igm_bf16_kernel<16><<<grid, NWARP * 32, 0, st>>>(xb, wb, ib, yb, B, K, Kc, N, ldw, wvec);
  }
  return cudaGetLastError();
}

extern "C" int igm_f32(const void* x, const void* w, const void* ridx, void* y, int B, int K,
                       int Kc, int N, int ldw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ldw < N) return cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return cudaSuccess;
  dim3 grid((B + F32_ROWS - 1) / F32_ROWS, (N + F32_THREADS - 1) / F32_THREADS);
  igm_f32_kernel<<<grid, F32_THREADS, 0, st>>>(static_cast<const float*>(x),
                                               static_cast<const float*>(w),
                                               static_cast<const int*>(ridx),
                                               static_cast<float*>(y), B, K, Kc, N, ldw);
  return cudaGetLastError();
}

namespace {

using sm90::bf16;

constexpr int I_KC = 64;                           // rows of a chunk
constexpr int I_STAGES = 4;
constexpr int I_W_BYTES = I_KC * 128 * 2;          // two swizzled 64 x 64 boxes
constexpr int I_XLD = 72;                          // padded x row, elements (144 B)
constexpr int I_X_BYTES = 16 * I_XLD * 2;
constexpr int I_THREADS = 160;                     // warps 0-3 consume, warp 4 produces
constexpr int I_LDR = 132;
constexpr size_t I_SMEM =
    1024 + I_STAGES * (I_W_BYTES + I_X_BYTES) + 2 * I_STAGES * sizeof(uint64_t);
static_assert(16 * I_LDR * 4 <= I_STAGES * I_X_BYTES, "partial must fit over the x tiles");

__global__ void __launch_bounds__(I_THREADS)
igm_decode_kernel(const __grid_constant__ CUtensorMap tmW, const bf16* __restrict__ x,
                  const int* __restrict__ ridx, bf16* __restrict__ y, int B, int K, int Kc,
                  int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* xt = ring + I_STAGES * I_W_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(xt + I_STAGES * I_X_BYTES);
  uint64_t* empty = full + I_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = gridDim.x, rank = blockIdx.x, n0 = blockIdx.y * 128;
  const int nch = (Kc + I_KC - 1) / I_KC;
  const int lo = rank * nch / c, hi = (rank + 1) * nch / c;

  if (tid == 0) {
    for (int s = 0; s < I_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);
    }
    sm90::fence_mbar_init();
  }
  __syncthreads();
  const int n = hi - lo;

  if (warp == 4) {
    // ---- producer warp: the weight ring, running I_STAGES chunks ahead ----
    for (int s = 0; s < n; ++s) {
      const int st = s % I_STAGES;
      if (s >= I_STAGES) sm90::mbar_wait(&empty[st], ((s / I_STAGES) - 1) & 1);
      if (lane == 0) {   // rows past Kc arrive as zeros (TMA out-of-bounds fill)
        unsigned char* wd = ring + st * I_W_BYTES;
        sm90::mbar_arrive_expect_tx(&full[st], I_W_BYTES);
        sm90::tma_2d(wd, &tmW, n0, (lo + s) * I_KC, &full[st]);
        sm90::tma_2d(wd + I_W_BYTES / 2, &tmW, n0 + 64, (lo + s) * I_KC, &full[st]);
      }
      __syncwarp();
    }
  } else {
    // ---- consumer warps: columns n0 + warp*32 .. +31 ------------------------
    // The four warps gather each chunk's (16, 64) slice of x together: lane
    // l of warp w holds column w*16 + l%16, rows l/16 + 2q.  The gather is
    // software-pipelined: the x values of chunk s+1 and the row_idx entries
    // of chunk s+2 are in flight while chunk s is computed.
    const bf16 zero = __float2bfloat16(0.f);
    const int col = warp * 16 + (lane & 15), r0 = lane >> 4;
    auto ridx_of = [&](int s) {
      const int k = (lo + s) * I_KC + col;
      return s < n && k < Kc ? __ldg(ridx + k) : -1;
    };
    auto load_x = [&](int i, bf16 (&v)[8]) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int r = r0 + 2 * q;
        v[q] = r < B && i >= 0 ? x[static_cast<long>(r) * K + i] : zero;
      }
    };
    bf16 v[8];
    load_x(ridx_of(0), v);
    int inext = ridx_of(1);
    float acc[4][4] = {};
    for (int s = 0; s < n; ++s) {
      const int st = s % I_STAGES;
      bf16* xs = reinterpret_cast<bf16*>(xt + st * I_X_BYTES);
#pragma unroll
      for (int q = 0; q < 8; ++q) xs[(r0 + 2 * q) * I_XLD + col] = v[q];
      asm volatile("bar.sync 2, 128;" ::: "memory");   // chunk s's x tile is whole
      load_x(inext, v);
      inext = ridx_of(s + 2);
      sm90::mbar_wait(&full[st], (s / I_STAGES) & 1);
      sm90::warp_tile_16x32<I_KC / 16, I_KC>(acc, xs, I_XLD, ring + st * I_W_BYTES, warp * 32);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[st]);
    }
    // the partial goes over the x tiles, once every consumer is done
    asm volatile("bar.sync 1, 128;" ::: "memory");
    sm90::store_warp_tile_16x32(acc, reinterpret_cast<float*>(xt), I_LDR, warp * 32);
  }
  sm90::cluster_reduce_store<I_THREADS>(reinterpret_cast<float*>(xt), I_LDR, B, min(128, N - n0),
                                        y + n0, N);
}

// xg[b, k] = x[b, row_idx[k]] for k < Kc, 0 for Kc <= k < Kp.
__global__ void gather_cols_kernel(const bf16* __restrict__ x, const int* __restrict__ ridx,
                                   bf16* __restrict__ xg, int K, int Kc, int Kp) {
  const int b = blockIdx.y, k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k < Kp)
    xg[static_cast<long>(b) * Kp + k] =
        k < Kc ? x[static_cast<long>(b) * K + __ldg(ridx + k)] : __float2bfloat16(0.f);
}

}  // namespace

// Whether a tensor map can describe the rows of w: row stride ldw >= N a
// multiple of 16 bytes, base 16-byte aligned (plans.igm_plan checks the same).
static bool tma_rows(const void* w, int N, int ldw) {
  return N >= 1 && ldw >= N && (2L * ldw) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
}

// Decode variant: 1 <= B <= 16, any N, w's rows as tma_rows takes them (the
// wrapper checks), 1 <= cluster <= 8.
extern "C" int igm_bf16_decode(const void* x, const void* w, const void* ridx, void* y, int B,
                               int K, int Kc, int N, int ldw, int cluster, void* stream) {
  if (B < 1 || B > 16 || !tma_rows(w, N, ldw) || Kc < 1 || cluster < 1 || cluster > 8)
    return cudaErrorInvalidValue;
  CUtensorMap mw;
  if (!sm90::cached_map(&mw, w, N, Kc, ldw, I_KC)) return cudaErrorInvalidValue;
  return sm90::launch_cluster(igm_decode_kernel, dim3(cluster, (N + 127) / 128), I_THREADS, I_SMEM,
                              static_cast<cudaStream_t>(stream), mw,
                              static_cast<const bf16*>(x), static_cast<const int*>(ridx),
                              static_cast<bf16*>(y), B, K, Kc, N);
}

// Prefill variant: any N, w's rows as tma_rows takes them, xg a (B, Kp)
// scratch buffer with Kp = Kc rounded up to 8, 1 <= cluster <= 8.
extern "C" int igm_bf16_prefill(const void* x, const void* w, const void* ridx, void* xg,
                                void* y, int B, int K, int Kc, int Kp, int N, int ldw,
                                int cluster, void* stream) {
  if (B < 1 || !tma_rows(w, N, ldw) || Kc < 1 || Kp < Kc || Kp % 8 || cluster < 1 ||
      cluster > 8)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gather_cols_kernel<<<dim3((Kp + 255) / 256, B), 256, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const int*>(ridx), static_cast<bf16*>(xg), K, Kc,
      Kp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  CUtensorMap ma, mb;
  if (!sm90::cached_map(&ma, xg, Kp, B, Kp, sm90::PM) ||
      !sm90::cached_map(&mb, w, N, Kc, ldw, sm90::PK))
    return cudaErrorInvalidValue;
  return sm90::launch_prefill<1>(ma, mb, nullptr, static_cast<bf16*>(y), B, N,
                                 (Kc + sm90::PK - 1) / sm90::PK, cluster, (N + 127) / 128, st);
}
