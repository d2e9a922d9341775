// FullBlock block-sparse matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/block_sparse_matmul.py:49 block_sparse_matmul_pallas
// (kernel body _kernel, :31-45).  Same function:
//   y[:, j*bn:(j+1)*bn] = sum_l x[:, idx[j,l]*bm : +bm] @ w_comp[j, l]
// with f32 accumulation and one cast to the input dtype at the end.  A
// slot with idx == -1 adds nothing wherever it sits in the list, so every
// variant skips it before it moves any byte (it does not stop at the
// first -1).
//
// Layout: x (B, K), w_comp (Gn, L, bm, bn), idx (Gn, L) int32, y (B, Gn*bn),
// all contiguous.  compress_fullblock pads every column group to the
// stack-wide L with -1 slots, so work is split over the LIVE slots of a
// row, never over L.
//
// The wrapper (block_sparse_matmul.py, through plans.bsm_plan) picks one
// variant before the launch, by dtype, B, block shape and alignment:
//
// decode (bf16, B <= 16, bm = bn = 128, x and w_comp 16-byte aligned).
//   Bound: bytes.  It does 2*B flops per weight read (8 at B = 4), far
//   below the ~295 flops/byte where an H100's tensor cores take over, so
//   the live weight blocks streamed once at 3.35 TB/s set the time.
//   Design: grid (c, Gn) in clusters of c CTAs, one cluster per column
//   group; CTA rank r takes live slots [r*n/c, (r+1)*n/c) of the n live
//   slots of its idx row (a fixed partition: plans.split_range).  A
//   producer warp fills a ring of D_STAGES = 3 shared-memory stages: each
//   stage is one 128 x 128 bf16 block (32 KB), brought in by two TMA
//   loads of 128 x 64 boxes with the 128-byte swizzle (so the consumers'
//   ldmatrix reads are free of bank conflicts), and the block's (B, 128)
//   slice of x, one 256-byte bulk copy per row into rows padded to 272
//   bytes.  All of it completes on the stage's mbarrier.  The weight's
//   tensor map is encoded once per weight address and kept
//   (sm90::cached_map), so a decode call does no host work for it.  Four
//   consumer warps run mma.sync m16n8k16 on x padded to 16 rows (rows past
//   B are zero), 32 columns each; then every CTA sums the cluster's f32
//   partials through distributed shared memory in rank order
//   (sm90::cluster_reduce_store): one launch, no atomics, bitwise
//   repeatable.
//   Not one bulk copy per 256-byte row, which would need no tensor map:
//   132 copies a stage ran at 18-32% of the byte bound on an H100 (about
//   60-90 ns per copy per SM, whatever the shape).  Nor one bulk copy of
//   the whole block: it lands rows 256 bytes apart, where the eight rows
//   of every ldmatrix share one bank group.
//   Sizing: at ~1 us of loaded memory latency the card needs 3.35 MB in
//   flight, ~25 KB per SM (~50 KB at 2 us).  A CTA holds 3 stages (96 KB
//   of weights + 13 KB of x, 110 KB with alignment), up to 3 blocks in
//   flight, and two CTAs fit on an SM.  c is the smallest power of two
//   (<= 8) that brings the grid to 128 CTAs while every CTA keeps at least
//   one slot (plans.BSM_DECODE_CTAS): llama3-8b wq and w_down (Gn 32)
//   take 4, w_gate/w_up (Gn 112) 2, wk/wv (Gn 8) 8 (64 CTAs; the portable
//   cluster limit caps them).  A sweep of c at these shapes (chip_smoke.py
//   prints it) found twice as many CTAs slower: each further split adds a
//   cluster barrier and a partial to sum, and one CTA per SM already
//   keeps ~96 KB in flight.
//
// prefill (bf16, B > 16, bm = bn = 128, aligned).  Bound: operations at
//   B = 512 (512 flops per weight byte, above the ~295 of the ridge).  Design
//   (sm90::gemm_prefill<0>): 128 x 128 output tiles, two consumer
//   warpgroups running wgmma m64n128k16 with f32 accumulators in
//   registers, fed by a 3-stage ring of TMA tensor-map loads (128-byte
//   swizzle) that one producer thread keeps in flight: x at
//   (idx*128 + h*64, row0) and the weight block as two 64-column boxes
//   of w_comp viewed as (Gn*L*128, 128), B operand MN-major; one wgmma
//   group stays in flight behind the next.  Where the grid is small
//   (wk/wv, Gn 8) a cluster splits the live slots and sums its partials
//   as above.  Both tensor maps come from sm90::cached_map.
//
// general (bf16, any other bm, bn multiple of 16, any alignment): one CTA
//   (4 warps) per (TB-row tile, column group), each live block staged in
//   shared memory with plain 16-byte loads (element loads where x or
//   w_comp is not 16-byte aligned) and accumulated with WMMA 16x16x16.
//
// f32 (bsm_f32): plain FMA in f32 (no TF32), one thread per output column
//   and 8 rows per CTA.  It is the precision reference on the card.
#include "sm90_common.cu"
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
                int B, int K, int Gn, int L, int bm, int bn, bool vec) {
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
    const __nv_bfloat16* wb = w + ((size_t)j * L + l) * bm * bn;
    if (vec) {    // x and w 16-byte aligned: 16-byte loads
      for (int i = tid; i < TB * xch; i += blockDim.x) {
        const int r = i / xch, c = (i % xch) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (row0 + r < B)
          val = *reinterpret_cast<const uint4*>(x + (size_t)(row0 + r) * K + (size_t)kb * bm + c);
        *reinterpret_cast<uint4*>(sX + r * bm + c) = val;
      }
      for (int i = tid; i < bm * bn / 8; i += blockDim.x)
        *reinterpret_cast<uint4*>(sW + i * 8) = *reinterpret_cast<const uint4*>(wb + (size_t)i * 8);
    } else {      // unaligned: element by element
      for (int i = tid; i < TB * bm; i += blockDim.x) {
        const int r = i / bm, c = i % bm;
        sX[i] = row0 + r < B ? x[(size_t)(row0 + r) * K + (size_t)kb * bm + c]
                             : __float2bfloat16(0.f);
      }
      for (int i = tid; i < bm * bn; i += blockDim.x) sW[i] = wb[i];
    }
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
  const bool vec =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  bsm_bf16_kernel<TB><<<grid, NWARP * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const int*>(idx), static_cast<__nv_bfloat16*>(y), B, K, Gn, L, bm, bn, vec);
  return cudaGetLastError();
}

}  // namespace

// General variant: any bm, bn that are multiples of 16 (bn <= 512) and
// any alignment.  Requires (TB/16)*(bn/16) <= 32 for the chosen TB; TB 64
// needs bn <= 128.
extern "C" int bsm_bf16_general(const void* x, const void* w, const void* idx, void* y, int B,
                                int K, int Gn, int L, int bm, int bn, void* stream) {
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

namespace {

using sm90::bf16;

constexpr int D_STAGES = 3;
constexpr int D_W_BYTES = 128 * 128 * 2;           // one block: two swizzled 128 x 64 boxes
constexpr int D_LDX = 136;                         // padded x row, elements (272 B)
constexpr int D_X_BYTES = 16 * D_LDX * 2;          // a block's x slice, 16 rows
constexpr int D_THREADS = 160;                     // warps 0-3 consume, warp 4 produces
constexpr int D_LDR = 132;                         // f32 partial row stride
constexpr size_t D_SMEM =
    1024 + D_STAGES * (D_W_BYTES + D_X_BYTES) + 2 * D_STAGES * sizeof(uint64_t);
static_assert(16 * D_LDR * 4 <= D_STAGES * D_X_BYTES, "partial must fit over the x tiles");

__global__ void __launch_bounds__(D_THREADS)
bsm_decode_kernel(const __grid_constant__ CUtensorMap tmW, const bf16* __restrict__ x,
                  const int* __restrict__ idx, bf16* __restrict__ y, int B, int K, int L) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* xt = ring + D_STAGES * D_W_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(xt + D_STAGES * D_X_BYTES);
  uint64_t* empty = full + D_STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = gridDim.x, rank = blockIdx.x, j = blockIdx.y;
  const int N = gridDim.y * 128;
  const int* row = idx + static_cast<long>(j) * L;

  if (tid == 0) {
    for (int s = 0; s < D_STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 4);
    }
    sm90::fence_mbar_init();
  }
  // rows of the x tiles past B stay zero: no copy ever writes them
  for (int i = tid; i < D_STAGES * D_X_BYTES / 16; i += D_THREADS)
    reinterpret_cast<uint4*>(xt)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int live = sm90::warp_count_live(row, L);
  const int lo = rank * live / c, hi = (rank + 1) * live / c;

  if (warp == 4) {
    // ---- producer warp: walk the idx row, load the slots [lo, hi) ---------
    int o = 0, s = 0;
    for (int b = 0; b < L && o < hi; b += 32) {
      const int l = b + lane;
      const int v = l < L ? __ldg(row + l) : -1;
      unsigned mask = __ballot_sync(0xffffffffu, v >= 0);
      while (mask) {
        const int bit = __ffs(mask) - 1;
        mask &= mask - 1;
        const int kb = __shfl_sync(0xffffffffu, v, bit);
        if (o >= lo && o < hi) {
          const int st = s % D_STAGES;
          if (s >= D_STAGES) sm90::mbar_wait(&empty[st], ((s / D_STAGES) - 1) & 1);
          if (lane == 0) {
            const int wrow = (j * L + b + bit) * 128;
            unsigned char* wd = ring + st * D_W_BYTES;
            sm90::mbar_arrive_expect_tx(&full[st], D_W_BYTES + B * 256);
            sm90::tma_2d(wd, &tmW, 0, wrow, &full[st]);
            sm90::tma_2d(wd + D_W_BYTES / 2, &tmW, 64, wrow, &full[st]);
          }
          __syncwarp();
          if (lane < B)
            sm90::bulk_g2s(xt + st * D_X_BYTES + lane * D_LDX * 2,
                           x + static_cast<long>(lane) * K + static_cast<long>(kb) * 128, 256,
                           &full[st]);
          ++s;
        }
        ++o;
      }
    }
  } else {
    // ---- consumer warps: columns warp*32 .. +31 of the column group -------
    float acc[4][4] = {};
    for (int s = 0; s < hi - lo; ++s) {
      const int st = s % D_STAGES;
      sm90::mbar_wait(&full[st], (s / D_STAGES) & 1);
      sm90::warp_tile_16x32<8, 128>(
          acc, reinterpret_cast<const bf16*>(xt + st * D_X_BYTES), D_LDX,
          ring + st * D_W_BYTES, warp * 32);
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(&empty[st]);
    }
    // the partial goes over the x tiles, once every consumer is done
    asm volatile("bar.sync 1, 128;" ::: "memory");
    sm90::store_warp_tile_16x32(acc, reinterpret_cast<float*>(xt), D_LDR, warp * 32);
  }
  sm90::cluster_reduce_store<D_THREADS>(reinterpret_cast<float*>(xt), D_LDR, B, 128,
                                        y + static_cast<long>(j) * 128, N);
}

}  // namespace

// Decode variant: B <= 16, bm = bn = 128, x and w 16-byte aligned (the
// wrapper checks), 1 <= cluster <= 8.
extern "C" int bsm_bf16_decode(const void* x, const void* w, const void* idx, void* y, int B,
                               int K, int Gn, int L, int cluster, void* stream) {
  if (B < 1 || B > 16 || cluster < 1 || cluster > 8 || K % 128) return cudaErrorInvalidValue;
  CUtensorMap mw;
  if (!sm90::cached_map(&mw, w, 128, static_cast<uint64_t>(Gn) * L * 128, 128, 128))
    return cudaErrorInvalidValue;
  return sm90::launch_cluster(bsm_decode_kernel, dim3(cluster, Gn), D_THREADS, D_SMEM,
                              static_cast<cudaStream_t>(stream), mw,
                              static_cast<const bf16*>(x), static_cast<const int*>(idx),
                              static_cast<bf16*>(y), B, K, L);
}

// Prefill variant: bm = bn = 128, x and w 16-byte aligned, 1 <= cluster <= 8.
extern "C" int bsm_bf16_prefill(const void* x, const void* w, const void* idx, void* y, int B,
                                int K, int Gn, int L, int cluster, void* stream) {
  if (B < 1 || cluster < 1 || cluster > 8 || K % 128) return cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  if (!sm90::cached_map(&ma, x, K, B, K, sm90::PM) ||
      !sm90::cached_map(&mb, w, 128, static_cast<uint64_t>(Gn) * L * 128, 128, sm90::PK))
    return cudaErrorInvalidValue;
  return sm90::launch_prefill<0>(ma, mb, static_cast<const int*>(idx), static_cast<bf16*>(y),
                                 B, Gn * 128, L, cluster, Gn, static_cast<cudaStream_t>(stream));
}
