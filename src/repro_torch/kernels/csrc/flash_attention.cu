// Causal / sliding-window flash attention for Hopper (sm_90a).
//
// Replaces repro/kernels/flash_attention.py:94 flash_attention_pallas
// (kernel body _kernel, :44-89).  Same function: softmax(q k^T / sqrt(hd))
// v with a causal and/or sliding-window mask, the finite -1e30 mask
// value, running max m, sum l and accumulator in f32, and P cast to the
// value dtype before P.V.  Each query tile visits only its live kv range
// [q_lo - window + 1, q_hi], so fully masked kv tiles are skipped.
//
// Layout: q (B, Sq, Hq, hd), k/v (B, Skv, Hkv, hd), contiguous.  GQA is
// handled by indexing kv head h / (Hq / Hkv) instead of repeating k/v.
//
// The wrapper (flash_attention.py, through plans.fa_plan) picks one
// variant before the launch, from dtype, head dim, shape and alignment:
//
// wgmma (bf16, hd 64, 128 or 256, causal with or without a window, Sq =
//   Skv = S a multiple of 128, 16-byte aligned).  Bound: at S = 512 the
//   causal work is about hd flops per byte (about 205 at hd 128 when 4 q
//   heads share a kv head), under the card's ridge (989 TFLOP/s / 3.35
//   TB/s, about 295), so bytes bound it; at S = 2048 operations do.  Either
//   way the first kernel below spent its time in shared-memory traffic,
//   which this design removes:
//   * Loads: one producer warp issues TMA tensor-map loads with the
//     128-byte swizzle.  Q is viewed as (hd, Hq, B*S) and its tile loaded
//     once as hd/64 boxes of 64 columns x PACK heads x P positions; K and V
//     as (Hkv*hd, B*S) in hd/64 boxes of 64 columns x BK keys from column
//     kv_head*hd, into a ring on mbarriers: 2 stages, 3 at hd 256, where a
//     stage is 64 KB and a third one ran faster on an H100
//     (sm90::tma_2d/tma_3d; the K/V maps from sm90::cached_map, copied out
//     of the table, Q's encoded per call).
//   * S = Q K^T: each consumer warpgroup owns 64 rows and issues hd/16
//     wgmma m64nBKk16, walking the boxes, with both operands K-major in
//     shared memory; the f32 scores stay in registers.
//   * Softmax in registers, in the log2 domain (scores times
//     log2(e)/sqrt(hd), exp2): the mask (finite -1e30) is applied only on
//     tiles that hold a masked pair (the diagonal and the window edge); a
//     row's max comes from shuffles among the 4 threads that hold it; each
//     thread keeps its share of the row sum l, summed across the 4 at the
//     end.  No score reaches shared memory.
//   * O += P V: P is rounded to bf16 in registers and fed to wgmma as the
//     A operand from registers; V is the MN-major B operand (leading
//     offset one 64-column box, stride 1 KB per 8 keys): m64n64k16 at hd
//     64, m64n128k16 at hd 128, two m64n128k16 over the two halves of V at
//     hd 256.  O (64 x hd f32 per warpgroup: 32, 64 or 128 floats a
//     thread) stays in registers.  The next tile's Q K^T group is issued
//     right behind the P V group, so the tensor cores run both back to
//     back while other warpgroups do their softmax.
//   * Epilogue: O / max(l, 1e-20) rounded once to bf16, written through the
//     warpgroup's own Q rows (XOR-swizzled, conflict-free) and stored with
//     16-byte writes.
//   * Grid: one CTA per (query tile, batch, head group), query tiles with
//     the most live kv tiles first, so the last wave is not the longest.
//   Levers, template parameters chosen per head dim by plans.fa_plan from
//   a sweep on the card (chip_smoke.py prints it): rows per CTA (64 or
//   128: one or two consumer warpgroups), keys per tile BK (64 or 128),
//   PACK, the q heads of one kv head that share a CTA and its K/V ring (1
//   or 4).  At hd 256 only 64 rows and 64 keys are built: a ring of
//   128-key stages would take 256 KB, and 128 rows neither fit beside the
//   3-stage ring (257 KB) nor kept O's 128 floats, S and P in registers
//   (ptxas gives a CTA of 288 threads 168 registers a thread; with two
//   stages they spilled and ran slower than 64 rows on an H100), where
//   one consumer warpgroup (160 threads) holds them without spilling.  A
//   warpgroup visits only its own live kv tiles and only releases the
//   others of its CTA.  Not kept: the next tile's Q K^T in flight during
//   the softmax (a second set of P registers, O rescaled after P V): it
//   compiled without spills but ran slower than the order below on an
//   H100 at S = 512 and 2048.
//
// general (bf16, any other shape: non-causal, Sq != Skv, S not a multiple
//   of 128, unaligned): the first kernel.  One CTA (4 warps) per (b*Hq +
//   h, 64-row query tile); Q and each 64-key K/V tile are staged in shared
//   memory with 16-byte loads (element by element where q, k or v is not
//   16-byte aligned); S = QK^T and O += PV run through WMMA 16x16x16 with
//   f32 accumulation, S, P and O kept in shared memory; each warp owns 16
//   query rows for the softmax update.
//
// f32 path: no tensor cores (TF32 would drop precision).  One warp per
// query row; each lane holds hd/32 elements of q and of the accumulator
// and walks the row's live keys one at a time with an exact online
// softmax.  It is the precision reference on the card, not a fast path.
#include "sm90_common.cu"
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;      // query rows per CTA
constexpr int BK = 64;      // keys per staged tile
constexpr int NWARP = 4;    // warps per CTA, 16 query rows each
constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr size_t bf16_smem_bytes() {
  return (size_t)(BQ * HD + 2 * BK * HD + BQ * BK) * sizeof(__nv_bfloat16)
       + (size_t)(BQ * BK + BQ * HD + 3 * BQ) * sizeof(float);
}

// Eight bf16 values from p: one 16-byte load, or eight 2-byte loads where
// q, k or v is not 16-byte aligned.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  const unsigned short* h = reinterpret_cast<const unsigned short*>(p);
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(h[2 * i]) | (static_cast<uint32_t>(h[2 * i + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int HD>
__global__ void __launch_bounds__(NWARP * 32)
fa_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               int Sq, int Skv, int Hq, int Hkv, int causal, int window, float scale,
               bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);   // BQ x HD
  __nv_bfloat16* sK = sQ + BQ * HD;                              // BK x HD
  __nv_bfloat16* sV = sK + BK * HD;                              // BK x HD
  __nv_bfloat16* sP = sV + BK * HD;                              // BQ x BK
  float* sS = reinterpret_cast<float*>(sP + BQ * BK);            // BQ x BK
  float* sO = sS + BQ * BK;                                      // BQ x HD
  float* sM = sO + BQ * HD;                                      // BQ
  float* sL = sM + BQ;                                           // BQ
  float* sC = sL + BQ;                                           // BQ

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q_lo = blockIdx.x * BQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const size_t qs = (size_t)Hq * HD, kvs = (size_t)Hkv * HD;
  const __nv_bfloat16* qb = q + (size_t)b * Sq * qs + (size_t)h * HD;
  const __nv_bfloat16* kb = k + (size_t)b * Skv * kvs + (size_t)hk * HD;
  const __nv_bfloat16* vb = v + (size_t)b * Skv * kvs + (size_t)hk * HD;
  constexpr int VEC = 8;            // bf16 per 16-byte load
  constexpr int CH = HD / VEC;

  for (int i = tid; i < BQ * CH; i += blockDim.x) {
    const int r = i / CH, c = (i % CH) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q_lo + r < Sq) val = load8(qb + (size_t)(q_lo + r) * qs + c, vec);
    *reinterpret_cast<uint4*>(sQ + r * HD + c) = val;
  }
  for (int i = tid; i < BQ * HD; i += blockDim.x) sO[i] = 0.f;
  for (int i = tid; i < BQ; i += blockDim.x) { sM[i] = NEG; sL[i] = 0.f; }

  const int q_hi = min(q_lo + BQ, Sq) - 1;
  const int key_hi = causal ? min(q_hi, Skv - 1) : Skv - 1;
  const int key_lo = window > 0 ? max(q_lo - window + 1, 0) : 0;
  __syncthreads();

  for (int t = key_lo / BK; t <= key_hi / BK; ++t) {
    const int k0 = t * BK;
    for (int i = tid; i < BK * CH; i += blockDim.x) {
      const int r = i / CH, c = (i % CH) * VEC;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < Skv) {
        kv = load8(kb + (size_t)(k0 + r) * kvs + c, vec);
        vv = load8(vb + (size_t)(k0 + r) * kvs + c, vec);
      }
      *reinterpret_cast<uint4*>(sK + r * HD + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * HD + c) = vv;
    }
    __syncthreads();

    // S[warp rows, :] = Q K^T on the tensor cores
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
#pragma unroll
      for (int d = 0; d < HD; d += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, sQ + warp * 16 * HD + d, HD);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
          wmma::load_matrix_sync(kf, sK + j * 16 * HD + d, HD);
          wmma::mma_sync(acc[j], a, kf, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(sS + warp * 16 * BK + j * 16, acc[j], BK, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this warp's 16 rows
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr, qi = q_lo + r;
      float s[BK / 32];
      float mx = NEG;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const int c = lane + 32 * u, ki = k0 + c;
        bool ok = ki < Skv;
        if (causal) ok = ok && ki <= qi;
        if (window > 0) ok = ok && ki > qi - window;
        s[u] = ok ? sS[r * BK + c] * scale : NEG;
        mx = fmaxf(mx, s[u]);
      }
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_cur = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < BK / 32; ++u) {
        const float p = expf(s[u] - m_cur);
        sP[r * BK + lane + 32 * u] = __float2bfloat16(p);
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_cur);
        sL[r] = sL[r] * corr + sum;
        sM[r] = m_cur;
        sC[r] = corr;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * HD; i += 32) {
      const int r = warp * 16 + i / HD;
      sO[r * HD + i % HD] *= sC[r];
    }
    __syncwarp();

    // O[warp rows, :] += P V on the tensor cores
#pragma unroll
    for (int d = 0; d < HD; d += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, sO + warp * 16 * HD + d, HD, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(a, sP + warp * 16 * BK + kk, BK);
        wmma::load_matrix_sync(vf, sV + kk * HD + d, HD);
        wmma::mma_sync(c, a, vf, c);
      }
      wmma::store_matrix_sync(sO + warp * 16 * HD + d, c, HD, wmma::mem_row_major);
    }
    __syncthreads();   // sK/sV are overwritten by the next tile
  }
  __syncthreads();

  for (int i = tid; i < BQ * HD; i += blockDim.x) {
    const int r = i / HD, c = i % HD;
    if (q_lo + r < Sq)
      o[(size_t)b * Sq * qs + (size_t)(q_lo + r) * qs + (size_t)h * HD + c] =
          __float2bfloat16(sO[i] / fmaxf(sL[r], 1e-20f));
  }
}

template <int HD>
__global__ void __launch_bounds__(NWARP * 32)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              int Sq, int Skv, int Hq, int Hkv, int causal, int window, float scale) {
  constexpr int E = HD / 32;   // elements per lane
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * NWARP + (threadIdx.x >> 5);
  if (qi >= Sq) return;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const size_t qs = (size_t)Hq * HD, kvs = (size_t)Hkv * HD;
  const float* qr = q + (size_t)b * Sq * qs + (size_t)qi * qs + (size_t)h * HD;
  const float* kb = k + (size_t)b * Skv * kvs + (size_t)hk * HD;
  const float* vb = v + (size_t)b * Skv * kvs + (size_t)hk * HD;
  float qv[E], acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) { qv[e] = qr[lane + 32 * e] * scale; acc[e] = 0.f; }
  const int hi = causal ? min(qi, Skv - 1) : Skv - 1;
  const int lo = window > 0 ? max(qi - window + 1, 0) : 0;
  float m = NEG, l = 0.f;
  for (int kj = lo; kj <= hi; ++kj) {
    const float* kr = kb + (size_t)kj * kvs;
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) dot = fmaf(qv[e], kr[lane + 32 * e], dot);
    dot = warp_sum(dot);
    const float m_cur = fmaxf(m, dot);
    const float corr = expf(m - m_cur);
    const float p = expf(dot - m_cur);
    l = l * corr + p;
    const float* vr = vb + (size_t)kj * kvs;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = fmaf(acc[e], corr, p * vr[lane + 32 * e]);
    m = m_cur;
  }
  float* orow = o + (size_t)b * Sq * qs + (size_t)qi * qs + (size_t)h * HD;
#pragma unroll
  for (int e = 0; e < E; ++e) orow[lane + 32 * e] = acc[e] / fmaxf(l, 1e-20f);
}

template <int HD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Skv, int Hq, int Hkv, int causal, int window, float scale,
                        cudaStream_t st) {
  const size_t smem = bf16_smem_bytes<HD>();
  cudaError_t e = cudaFuncSetAttribute(fa_bf16_kernel<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  fa_bf16_kernel<HD><<<grid, NWARP * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv,
      causal, window, scale, vec);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                       int Skv, int Hq, int Hkv, int causal, int window, float scale,
                       cudaStream_t st) {
  dim3 grid((Sq + NWARP - 1) / NWARP, B * Hq);
  fa_f32_kernel<HD><<<grid, NWARP * 32, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), Sq, Skv, Hq, Hkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// wgmma variant (bf16, hd 64 / 128 / 256, causal, Sq = Skv a multiple of 128)
// ---------------------------------------------------------------------------

namespace fa3 {

using sm90::bf16;
using namespace sm90;

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128], both K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] (bf16 pairs in registers) * B[16 x 128] (MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] (bf16 pairs in registers) * B[16 x 64] (MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x hd] += P V_t for one 16-key step: O is NG groups of OD floats a
// thread (the accumulator of an m64n(2*OD) wgmma each), V's boxes start
// box_bytes apart.
template <int NG, int OD>
__device__ __forceinline__ void wgmma_pv(float (&o)[NG][OD], const uint32_t (&a)[4],
                                         const unsigned char* v, int box_bytes) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const uint64_t db = desc_sw128(v + g * (2 * OD / 64) * box_bytes, box_bytes, 1024);
    if constexpr (OD == 32) wgmma_rs_n64(o[g], a, db);
    else wgmma_rs_n128(o[g], a, db);
  }
}

// One CTA: NWG consumer warpgroups of 64 rows each, plus one producer warp.
// A row is one (query position, q head) pair; PACK q heads of one kv head
// share the CTA (rows ordered position-major, head-minor), so the CTA
// covers P = 64 * NWG / PACK positions and loads each K/V tile once for
// all PACK heads.
template <int HD, int NWG, int BK, int PACK>
struct Cfg {
  static constexpr int BQ = 64 * NWG;          // rows per CTA
  static constexpr int P = BQ / PACK;          // query positions per CTA
  static constexpr int STAGES = HD == 256 ? 3 : 2;   // K/V ring depth
  static constexpr int BOXES = HD / 64;        // 64-column (128-byte) boxes of a row
  static constexpr int Q_BOX = BQ * 128;       // one box of the Q tile, bytes
  static constexpr int KV_BOX = BK * 128;      // one box of a K or V tile
  static constexpr int STAGE = 2 * BOXES * KV_BOX;   // K and V tiles
  static constexpr int THREADS = 128 * NWG + 32;
  static constexpr int NG = HD > 128 ? HD / 128 : 1;   // O accumulator groups
  static constexpr int OD = (HD > 128 ? 128 : HD) / 2; // floats a thread per group
  static constexpr size_t SMEM = 1024 + BOXES * Q_BOX + STAGES * STAGE + (2 * STAGES + 1) * 8;
  static_assert(SMEM <= 232448, "the tile does not fit an SM's shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void fence_u32(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Live kv tiles [lo, hi] of the query positions [p_lo, p_hi] (causal, an
// optional window); plans.fa_live_tiles mirrors it.
__device__ __forceinline__ int live_lo(int p_lo, int window, int BK) {
  return window > 0 ? max(p_lo - window + 1, 0) / BK : 0;
}

// Whether tile t holds a masked (position, key) pair for positions
// [p_lo, p_hi]; plans.fa_tile_needs_mask mirrors it.
__device__ __forceinline__ bool needs_mask(int t, int p_lo, int p_hi, int window, int BK) {
  return t * BK + BK - 1 > p_lo || (window > 0 && t * BK <= p_hi - window);
}

template <int HD, int NWG, int BK, int PACK>
__global__ void __launch_bounds__(Cfg<HD, NWG, BK, PACK>::THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tmQ, const __grid_constant__ CUtensorMap tmK,
                const __grid_constant__ CUtensorMap tmV, bf16* __restrict__ o, int B, int S,
                int Hq, int Hkv, int window, float scale_log2) {
  using C = Cfg<HD, NWG, BK, PACK>;
  constexpr int SN = BK / 2;                    // S accumulator floats per thread
  constexpr int NG = C::NG, OD = C::OD;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* qs = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* ring = qs + C::BOXES * C::Q_BOX;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::STAGES * C::STAGE);
  uint64_t* empty = full + C::STAGES;
  uint64_t* qbar = empty + C::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // heavy-first order: the last query tiles (most live kv tiles) first;
  // plans.fa_tile_order mirrors it
  const int groups = Hq / PACK, per_qt = B * groups, n_qt = S / C::P;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / per_qt;
  const int rem = static_cast<int>(blockIdx.x) % per_qt;
  const int b = rem / groups, hq0 = (rem % groups) * PACK, hk = hq0 / (Hq / Hkv);
  const int q_lo = qt * C::P;
  const int lo = live_lo(q_lo, window, BK), hi = (q_lo + C::P - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128 * NWG);
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // ---- producer: one lane issues every TMA load -------------------------
    if (lane == 0) {
      const int qrow = b * S + q_lo;
      mbar_arrive_expect_tx(qbar, C::BOXES * C::Q_BOX);
#pragma unroll
      for (int j = 0; j < C::BOXES; ++j) tma_3d(qs + j * C::Q_BOX, &tmQ, 64 * j, hq0, qrow, qbar);
      for (int s = 0; s <= hi - lo; ++s) {
        const int st = s % C::STAGES;
        if (s >= C::STAGES) mbar_wait(&empty[st], ((s / C::STAGES) - 1) & 1);
        unsigned char* base = ring + st * C::STAGE;
        const int row = b * S + (lo + s) * BK, col = hk * HD;
        mbar_arrive_expect_tx(&full[st], C::STAGE);
#pragma unroll
        for (int j = 0; j < C::BOXES; ++j) {
          tma_2d(base + j * C::KV_BOX, &tmK, col + 64 * j, row, &full[st]);
          tma_2d(base + (C::BOXES + j) * C::KV_BOX, &tmV, col + 64 * j, row, &full[st]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns CTA rows wg*64 .. wg*64+63 -----------
    const int wg = warp >> 2, g = lane >> 2, tq = lane & 3;
    const int r0 = (warp & 3) * 16 + g;                 // WG row of s/o[4i], [4i+1]
    const int pos0 = q_lo + (wg * 64 + r0) / PACK, pos1 = q_lo + (wg * 64 + r0 + 8) / PACK;
    const int wp_lo = q_lo + (wg * 64) / PACK, wp_hi = q_lo + (wg * 64 + 63) / PACK;
    const int wlo = live_lo(wp_lo, window, BK), whi = wp_hi / BK;
    const unsigned char* qa = qs + wg * 64 * 128;

    float acc[NG][OD], sa[SN];
#pragma unroll
    for (int j = 0; j < NG; ++j)
#pragma unroll
      for (int i = 0; i < OD; ++i) acc[j][i] = 0.f;
#pragma unroll
    for (int i = 0; i < SN; ++i) sa[i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;       // l: this thread's share

    auto fence_acc = [&]() {
#pragma unroll
      for (int j = 0; j < NG; ++j) fence_regs(acc[j]);
    };
    auto stage_of = [&](int t) { return (t - lo) % C::STAGES; };
    auto parity_of = [&](int t) { return static_cast<uint32_t>(((t - lo) / C::STAGES) & 1); };
    auto issue_qk = [&](int t, float (&s)[SN]) {         // S = Q K_t^T, one group
      mbar_wait(&full[stage_of(t)], parity_of(t));
      const unsigned char* kt = ring + stage_of(t) * C::STAGE;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint64_t da = desc_sw128(qa + (kk >> 2) * C::Q_BOX + (kk & 3) * 32, 16, 1024);
        const uint64_t db = desc_sw128(kt + (kk >> 2) * C::KV_BOX + (kk & 3) * 32, 16, 1024);
        if constexpr (BK == 128) wgmma_ss_n128(s, da, db, kk > 0);
        else wgmma_ss_n64(s, da, db, kk > 0);
      }
      wgmma_commit();
    };

    // Softmax of tile t's scores in registers (log2 domain), in place: m
    // and this thread's share of l updated, P packed as the A operand of
    // P.V (keys 16kk..+7 from i = 2kk, +8..+15 from i = 2kk + 1) and the
    // factors that rescale O returned.
    auto softmax = [&](float (&sc)[SN], int t, uint32_t (&pa)[BK / 16][4], float& c0,
                       float& c1) {
      const bool masked = needs_mask(t, wp_lo, wp_hi, window, BK);
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int i = 0; i < SN / 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float v = sc[4 * i + j] * scale_log2;
          if (masked) {
            const int key = t * BK + 8 * i + 2 * tq + (j & 1);
            const int pos = j < 2 ? pos0 : pos1;
            v = key <= pos && (window <= 0 || key > pos - window) ? v : NEG;
          }
          sc[4 * i + j] = v;
          if (j < 2) mx0 = fmaxf(mx0, v);
          else mx1 = fmaxf(mx1, v);
        }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      c0 = exp2f(m0 - n0);
      c1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int i = 0; i < SN / 4; ++i) {
        const float p0 = exp2f(sc[4 * i] - n0), p1 = exp2f(sc[4 * i + 1] - n0);
        const float p2 = exp2f(sc[4 * i + 2] - n1), p3 = exp2f(sc[4 * i + 3] - n1);
        ps0 += p0 + p1;
        ps1 += p2 + p3;
        pa[i >> 1][(i & 1) * 2] = pack_bf16(p0, p1);
        pa[i >> 1][(i & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
    };
    auto rescale = [&](float c0, float c1) {
#pragma unroll
      for (int j = 0; j < NG; ++j)
#pragma unroll
        for (int i = 0; i < OD / 4; ++i) {
          acc[j][4 * i] *= c0;
          acc[j][4 * i + 1] *= c0;
          acc[j][4 * i + 2] *= c1;
          acc[j][4 * i + 3] *= c1;
        }
    };
    auto issue_pv = [&](int t, uint32_t (&pa)[BK / 16][4]) {     // O += P V_t, one group
      const unsigned char* vt = ring + stage_of(t) * C::STAGE + C::BOXES * C::KV_BOX;
      fence_acc();
      fence_u32(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_pv(acc, pa[kk], vt + kk * 16 * 128, C::KV_BOX);
      wgmma_commit();
    };

    // tiles of the CTA before this warpgroup's range: release only
    for (int t = lo; t < wlo; ++t) {
      mbar_wait(&full[stage_of(t)], parity_of(t));
      mbar_arrive(&empty[stage_of(t)]);
    }
    mbar_wait(qbar, 0);
    issue_qk(wlo, sa);
    wgmma_wait<0>();
    fence_regs(sa);
    // softmax, then P V and the next tile's Q K^T back to back: the
    // tensor cores run both while other warpgroups do their softmax
    for (int t = wlo; t <= whi; ++t) {
      uint32_t pa[BK / 16][4];
      float c0, c1;
      softmax(sa, t, pa, c0, c1);
      rescale(c0, c1);
      issue_pv(t, pa);
      if (t < whi) issue_qk(t + 1, sa);
      wgmma_wait<0>();
      fence_acc();
      fence_regs(sa);
      fence_u32(pa);
      mbar_arrive(&empty[stage_of(t)]);
    }
    // tiles of the CTA after this warpgroup's range: release only
    for (int t = whi + 1; t <= hi; ++t) {
      mbar_wait(&full[stage_of(t)], parity_of(t));
      mbar_arrive(&empty[stage_of(t)]);
    }

    // -- epilogue: O / l as bf16 through this warpgroup's Q rows ------------
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-20f), d1 = fmaxf(l1, 1e-20f);
    unsigned char* os = qs + wg * 64 * 128;             // rows r of every box
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {                  // columns 8i .. 8i+7
      const int box = i >> 3, ch = i & 7, gi = i / (OD / 4), e = 4 * (i % (OD / 4));
      unsigned char* p = os + box * C::Q_BOX + tq * 4;
      *reinterpret_cast<uint32_t*>(p + r0 * 128 + ((ch ^ (r0 & 7)) << 4)) =
          pack_bf16(acc[gi][e] / d0, acc[gi][e + 1] / d0);
      *reinterpret_cast<uint32_t*>(p + (r0 + 8) * 128 + ((ch ^ ((r0 + 8) & 7)) << 4)) =
          pack_bf16(acc[gi][e + 2] / d1, acc[gi][e + 3] / d1);
    }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    const int wt = tid & 127;
    constexpr int CPR = HD / 8;                         // 16-byte chunks of a row
#pragma unroll
    for (int it = 0; it < 64 * CPR / 128; ++it) {
      const int e = it * 128 + wt, r = e / CPR, c = e % CPR;
      const uint4 val = *reinterpret_cast<const uint4*>(
          os + (c >> 3) * C::Q_BOX + r * 128 + (((c & 7) ^ (r & 7)) << 4));
      const int R = wg * 64 + r;
      const size_t row = (static_cast<size_t>(b) * S + q_lo + R / PACK) * Hq + hq0 + R % PACK;
      *reinterpret_cast<uint4*>(o + row * HD + c * 8) = val;
    }
  }
}

template <int HD, int NWG, int BK, int PACK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int S, int Hq,
                   int Hkv, int window, float scale, cudaStream_t st) {
  using C = Cfg<HD, NWG, BK, PACK>;
  CUtensorMap mq, mk, mv;
  const uint64_t rows = static_cast<uint64_t>(B) * S, kv_w = static_cast<uint64_t>(Hkv) * HD;
  // K and V maps come from the table; Q's is encoded anew (once per call)
  if (!encode_bf16_3d(&mq, q, HD, Hq, rows, HD, static_cast<uint64_t>(Hq) * HD, PACK, C::P) ||
      !cached_map(&mk, k, kv_w, rows, kv_w, BK) || !cached_map(&mv, v, kv_w, rows, kv_w, BK))
    return cudaErrorInvalidValue;
  auto kernel = fa_wgmma_kernel<HD, NWG, BK, PACK>;
  cudaError_t e = set_smem_once(reinterpret_cast<const void*>(kernel), C::SMEM);
  if (e != cudaSuccess) return e;
  const int grid = (S / C::P) * B * (Hq / PACK);
  kernel<<<grid, C::THREADS, C::SMEM, st>>>(mq, mk, mv, static_cast<bf16*>(o), B, S, Hq, Hkv,
                                            window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace fa3

// window <= 0 means no window.  Returns cudaErrorInvalidValue for a head
// dim other than 64, 128 or 256 (the wrapper checks first).
extern "C" int fa_fwd_bf16(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                           int Skv, int Hq, int Hkv, int hd, int causal, int window, float scale,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_bf16<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, st);
    case 128: return launch_bf16<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, st);
    case 256: return launch_bf16<256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int fa_fwd_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                          int Skv, int Hq, int Hkv, int hd, int causal, int window, float scale,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_f32<64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, st);
    case 128: return launch_f32<128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, st);
    case 256: return launch_f32<256>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// The wgmma variant: bf16, hd 64, 128 or 256, causal, Sq = Skv = S a
// multiple of 128; rows (query rows per CTA) 64 or 128 (64 only at hd 256),
// keys (per kv tile) 64 or 128 (64 only at hd 256), pack (q heads per CTA) 1 or 4 with
// (Hq / Hkv) % pack == 0; q, k, v and o 16-byte aligned.  window <= 0 means
// no window.  Any other setting returns cudaErrorInvalidValue
// (plans.FA_BUILT lists the ones built).
extern "C" int fa_fwd_bf16_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                                 int S, int Hq, int Hkv, int hd, int window, float scale,
                                 int rows, int keys, int pack, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S % 128 || Hkv <= 0 || Hq % Hkv || pack <= 0 || (Hq / Hkv) % pack)
    return cudaErrorInvalidValue;
#define FA_CASE(H, R, K, P)                                                               \
  if (hd == H && rows == R && keys == K && pack == P)                                     \
    return fa3::launch<H, R / 64, K, P>(q, k, v, o, B, S, Hq, Hkv, window, scale, st);
#define FA_CASES(H)                                                                       \
  FA_CASE(H, 128, 64, 1)                                                                  \
  FA_CASE(H, 128, 64, 4)                                                                  \
  FA_CASE(H, 64, 64, 1)                                                                   \
  FA_CASE(H, 64, 64, 4)
#define FA_CASES_BK128(H)                                                                 \
  FA_CASE(H, 128, 128, 1)                                                                 \
  FA_CASE(H, 128, 128, 4)                                                                 \
  FA_CASE(H, 64, 128, 1)                                                                  \
  FA_CASE(H, 64, 128, 4)
  FA_CASES(64)
  FA_CASES_BK128(64)
  FA_CASES(128)
  FA_CASES_BK128(128)
  FA_CASE(256, 64, 64, 1)
  FA_CASE(256, 64, 64, 4)
#undef FA_CASES_BK128
#undef FA_CASES
#undef FA_CASE
  return cudaErrorInvalidValue;
}
