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
// bf16 path: one CTA (4 warps) per (b*Hq + h, 64-row query tile).  The
// Q tile and each 64-key K/V tile are staged in shared memory; S = QK^T
// and O += PV run on the tensor cores through WMMA 16x16x16 bf16 tiles
// with f32 accumulation.  S, P and the f32 accumulator O stay in shared
// memory, so no score ever reaches device memory.  Each warp owns 16
// query rows for the softmax update and the rescale of O.
// Bound: at prefill shapes (S = 512, hd = 128) the causal work is about
// 4*hd*S^2/2 flops per head against (3+1)*S*hd*2 bytes, about 128 flops
// per byte (about 205 when 4 q heads share a kv head), below the card's
// ridge (989 TFLOP/s / 3.35 TB/s, about 295), so device-memory bytes
// bound it.  This first version does not
// pipeline the K/V loads (no cp.async / TMA, no wgmma).
//
// f32 path: no tensor cores (TF32 would drop precision).  One warp per
// query row; each lane holds hd/32 elements of q and of the accumulator
// and walks the row's live keys one at a time with an exact online
// softmax.  It is the precision reference on the card, not a fast path.
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

template <int HD>
__global__ void __launch_bounds__(NWARP * 32)
fa_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
               int Sq, int Skv, int Hq, int Hkv, int causal, int window, float scale) {
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
    if (q_lo + r < Sq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q_lo + r) * qs + c);
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
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kvs + c);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * kvs + c);
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
  fa_bf16_kernel<HD><<<grid, NWARP * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Sq, Skv, Hq, Hkv,
      causal, window, scale);
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
