// Decode attention over a slot-indexed bf16 K/V cache, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes decode attention in jnp
// (chunked_attention over the whole cache after write_cache), and so did
// the port until this kernel, widening every slot's K and V to f32 on each
// layer of each step.  One launch does what those did for one layer of a
// decode step: it writes the step's new k/v into the cache and attends q
// (one query token per slot, G = Hq / Hkv query heads per kv head) over
// keys 0..pos of each slot, as write_cache + chunked_attention do.
//
// What bounds it: device-memory bytes.  A key costs 2 * 128 * 2 bytes of
// K and V and 4 * 128 * G flops, under 16 flops a byte; the card's
// balance point is near 295.  The design reads each byte it needs once
// and no other:
//
// * GQA sharing: one CTA serves all G query heads of its kv head, so a
//   K/V byte is read once per kv head, not once per query head;
// * stopping at pos: a CTA reads pos[b] on the device and streams only
//   keys 0..pos of its slot; the cache's unwritten tail is never read;
// * splits that fill the card: the grid is (split, kv head, slot), each
//   split a fixed range of `chunk` keys (plans.da_plan picks it from the
//   shapes alone, never from pos, so a CUDA graph can replay a launch).
//   Splits past a slot's last key exit at once.
//
// A CTA is 4 warps.  16-byte cp.async loads fill a 3-stage ring of
// 64-key tiles (K and V, 32 KB a stage, 96 KB: two CTAs share an SM),
// rows swizzled so that ldmatrix reads are free of bank conflicts.  Each
// warp takes 16 keys of every tile and keeps its own online softmax:
// S = Q K^T by mma.sync m16n8k16 (bf16 products, f32 sums; the G query
// rows padded to 16), scaled by 1/sqrt(hd), the running max, sum and
// accumulator in f32, p rounded to bf16 before P V (mma.sync, f32 sums),
// as chunked_attention rounds p to the value dtype.  The warps' states
// merge in shared memory into the CTA's (m, l, acc), written to scratch;
// the last CTA of a (slot, kv head) to finish (a ticket per pair, set
// back to 0 by that CTA) merges the splits and writes the output in
// q's dtype.
//
// The write: per-slot pos (B,) writes row b at pos[b] and drops it where
// pos[b] >= Smax (a negative pos wraps once, as a PyTorch index does); a
// scalar pos writes every row at pos clamped to [0, Smax - 1].  The CTA
// whose split holds the slot writes it before it loads, and patches its
// shared-memory copy of that row from the new k/v, so that no other CTA
// reads the slot and its own read needs no ordering against the store.
// The query sees keys 0..min(pos, Smax - 1): a dropped write leaves the
// old slot in place and attends it, as the plain path does.
#include "sm90_common.cu"

namespace {

using sm90::bf16;

constexpr int HD = 128;                          // head dim
constexpr int TILE = 64;                         // keys per ring stage
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;
constexpr int ROW_BYTES = HD * 2;                // one key's K (or V) row: 16 chunks of 16 B
constexpr int TILE_BYTES = TILE * ROW_BYTES;     // 16 KB
constexpr int STAGE_BYTES = 2 * TILE_BYTES;      // K then V
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES; // 96 KB
constexpr int MAX_G = 16;                        // query rows of an mma tile
constexpr int RED_LD = HD + 4;                   // floats a row of the warps' merge
static_assert(THREADS == HD, "the merges give each thread one dim");
static_assert((WARPS * MAX_G * RED_LD + 2 * WARPS * MAX_G) * 4 <= SMEM_BYTES,
              "the warps' merge reuses the ring");

struct Args {
  const bf16* q;        // (B, Hq, HD)
  const bf16* k_new;    // (B, Hkv, HD)
  const bf16* v_new;    // (B, Hkv, HD)
  bf16* K;              // (B, Smax, Hkv, HD)
  bf16* V;              // (B, Smax, Hkv, HD)
  const long long* pos; // (B,) per slot, or one scalar
  int pos_stride;       // 1 per slot, 0 scalar
  float* part;          // acc (B*Hkv*nsplit*G, HD), then m and l (B*Hkv*nsplit*G) each
  int* tickets;         // (B*Hkv), 0 between launches
  bf16* out;            // (B, Hq, HD)
  int Smax, Hkv, G, chunk, nsplit;
  float scale;
};

// byte offset of 16-byte chunk c of row r in a K or V tile
__device__ __forceinline__ int swz(int r, int c) { return r * ROW_BYTES + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(sm90::smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Keys s0..s0+TILE-1 of K and V (rows `ld` elements apart) into a ring
// stage; rows at or past `kend` are filled with zeros and read nothing.
__device__ __forceinline__ void load_tile(unsigned char* ks, const bf16* Kb, const bf16* Vb,
                                          int s0, int kend, size_t ld, int tid) {
#pragma unroll
  for (int i = 0; i < TILE * 16 / THREADS; ++i) {
    const int idx = i * THREADS + tid;
    const int r = idx >> 4, c = idx & 15;
    const bool ok = s0 + r < kend;
    const size_t off = (size_t)(ok ? s0 + r : 0) * ld + c * 8;
    cp_async16(ks + swz(r, c), Kb + off, ok ? 16 : 0);
    cp_async16(ks + TILE_BYTES + swz(r, c), Vb + off, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 2) da_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int Smax = a.Smax, G = a.G;
  const long long p = a.pos[(long long)a.pos_stride * b];
  const int n_keys = p < 0 ? 0 : (p >= Smax ? Smax : (int)p + 1);
  int ws;   // the slot the new k/v go to, -1 where the write is dropped
  if (a.pos_stride == 0)
    ws = p < 0 ? 0 : (p >= Smax ? Smax - 1 : (int)p);
  else
    ws = p >= Smax ? -1 : (p >= 0 ? (int)p : (p >= -Smax ? (int)(p + Smax) : -1));

  const int c0 = split * a.chunk;
  const int c1 = min(c0 + a.chunk, Smax);
  const size_t bh = (size_t)b * a.Hkv + h;
  const size_t ld = (size_t)a.Hkv * HD;                       // elements between keys
  bf16* Kb = a.K + (size_t)b * Smax * ld + (size_t)h * HD;
  bf16* Vb = a.V + (size_t)b * Smax * ld + (size_t)h * HD;
  const bf16* knew = a.k_new + bh * HD;
  const bf16* vnew = a.v_new + bh * HD;
  if (ws >= c0 && ws < c1 && tid < 32) {
    const int c = tid & 15;
    const uint4 val = reinterpret_cast<const uint4*>(tid < 16 ? knew : vnew)[c];
    reinterpret_cast<uint4*>((tid < 16 ? Kb : Vb) + (size_t)ws * ld)[c] = val;
  }
  const int n_live = max(1, (n_keys + a.chunk - 1) / a.chunk);
  if (split >= n_live) return;

  // Q as mma A fragments (rows = the G query heads, zero past G)
  uint32_t qa[HD / 16][4];
  const bf16* qh = a.q + bh * G * HD;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int d = kk * 16 + 2 * t;
    qa[kk][0] = g < G ? ld32(qh + g * HD + d) : 0u;
    qa[kk][1] = g + 8 < G ? ld32(qh + (g + 8) * HD + d) : 0u;
    qa[kk][2] = g < G ? ld32(qh + g * HD + d + 8) : 0u;
    qa[kk][3] = g + 8 < G ? ld32(qh + (g + 8) * HD + d + 8) : 0u;
  }

  const int kend = min(c1, n_keys);
  const int n_tiles = kend > c0 ? (kend - c0 + TILE - 1) / TILE : 0;

  const float NEG_INF = __uint_as_float(0xff800000u);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows g and g + 8
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(smem + s * STAGE_BYTES, Kb, Vb, c0 + s * TILE, kend, ld, tid);
    cp_async_commit();
  }
  const int kr = warp * 16;                                // the warp's first key of a tile
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                                     // tile landed; tile - 1's stage free
    const int nt = tile + STAGES - 1;
    if (nt < n_tiles)
      load_tile(smem + (nt % STAGES) * STAGE_BYTES, Kb, Vb, c0 + nt * TILE, kend, ld, tid);
    cp_async_commit();
    unsigned char* ks = smem + (tile % STAGES) * STAGE_BYTES;
    unsigned char* vs = ks + TILE_BYTES;
    const int s0 = c0 + tile * TILE;
    if (ws >= s0 && ws < s0 + TILE) {                    // the written slot: the new k/v
      if (tid < 32) {
        const int c = tid & 15;
        *reinterpret_cast<uint4*>((tid < 16 ? ks : vs) + swz(ws - s0, c)) =
            reinterpret_cast<const uint4*>(tid < 16 ? knew : vnew)[c];
      }
      __syncthreads();
    }

    // S = Q K^T over the warp's 16 keys: two n8 tiles
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int mi = lane >> 3;
      const int row = kr + (mi >> 1) * 8 + (lane & 7);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t bk[4];
        sm90::ldsm_x4(bk, ks + swz(row, 2 * kk + (mi & 1)));
        sm90::mma_bf16(sc[0], qa[kk], bk[0], bk[1]);
        sm90::mma_bf16(sc[1], qa[kk], bk[2], bk[3]);
      }
    }

    // online softmax; sc[j][e] is row g (e < 2) or g + 8, key kr + 8j + 2t + (e & 1)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = s0 + kr + 8 * j + 2 * t + (e & 1) < kend;
        sc[j][e] = ok ? sc[j][e] * a.scale : NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    float corr[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      ms[r] = mn == NEG_INF ? 0.f : mn;
      corr[r] = m[r] == NEG_INF ? 0.f : expf(m[r] - ms[r]);
      m[r] = mn;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = expf(sc[j][e] - ms[e >> 1]);
        l[e >> 1] += sc[j][e];
      }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};

    // O += P V: V's rows are the keys (k), its columns the dims (n)
    {
      const int mi = lane >> 3;
      const int row = kr + (mi & 1) * 8 + (lane & 7);
#pragma unroll
      for (int pp = 0; pp < HD / 16; ++pp) {
        uint32_t bv[4];
        sm90::ldsm_x4_t(bv, vs + swz(row, 2 * pp + (mi >> 1)));
        sm90::mma_bf16(acc[2 * pp], pa, bv[0], bv[1]);
        sm90::mma_bf16(acc[2 * pp + 1], pa, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                                       // the ring is free for the merge

  // merge the warps' states in shared memory
  float* red = reinterpret_cast<float*>(smem);           // [WARPS][MAX_G][RED_LD]
  float* red_m = red + WARPS * MAX_G * RED_LD;           // [WARPS][MAX_G]
  float* red_l = red_m + WARPS * MAX_G;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* wr = red + warp * MAX_G * RED_LD;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    wr[g * RED_LD + 8 * n + 2 * t] = acc[n][0];
    wr[g * RED_LD + 8 * n + 2 * t + 1] = acc[n][1];
    wr[(g + 8) * RED_LD + 8 * n + 2 * t] = acc[n][2];
    wr[(g + 8) * RED_LD + 8 * n + 2 * t + 1] = acc[n][3];
  }
  if (t == 0) {
    red_m[warp * MAX_G + g] = m[0];
    red_m[warp * MAX_G + g + 8] = m[1];
    red_l[warp * MAX_G + g] = l[0];
    red_l[warp * MAX_G + g + 8] = l[1];
  }
  __syncthreads();

  const size_t rows = (size_t)gridDim.z * a.Hkv * a.nsplit * G;
  float* pacc = a.part;
  float* pm = a.part + rows * HD;
  float* pl = pm + rows;
  const size_t mine = (bh * a.nsplit + split) * G;
  for (int r = 0; r < G; ++r) {
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, red_m[w * MAX_G + r]);
    const float Ms = M == NEG_INF ? 0.f : M;
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float mw = red_m[w * MAX_G + r];
      const float e = mw == NEG_INF ? 0.f : expf(mw - Ms);
      L += red_l[w * MAX_G + r] * e;
      A += red[(w * MAX_G + r) * RED_LD + tid] * e;
    }
    pacc[(mine + r) * HD + tid] = A;
    if (tid == 0) {
      pm[mine + r] = M;
      pl[mine + r] = L;
    }
  }

  // the last of the pair's live splits merges them
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int ticket = atomicAdd(a.tickets + bh, 1);
    last = ticket == n_live - 1;
    if (last) a.tickets[bh] = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t first = bh * a.nsplit * G;
  bf16* o = a.out + bh * G * HD;
  for (int r = 0; r < G; ++r) {
    float M = NEG_INF;
    for (int s = 0; s < n_live; ++s) M = fmaxf(M, __ldcg(pm + first + s * G + r));
    const float Ms = M == NEG_INF ? 0.f : M;
    float L = 0.f, A = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const size_t i = first + (size_t)s * G + r;
      const float ms_ = __ldcg(pm + i);
      const float e = ms_ == NEG_INF ? 0.f : expf(ms_ - Ms);
      L += __ldcg(pl + i) * e;
      A += __ldcg(pacc + i * HD + tid) * e;
    }
    o[r * HD + tid] = __float2bfloat16(A / fmaxf(L, 1e-20f));
  }
}

}  // namespace

// q (B, Hq, 128), k_new/v_new (B, Hkv, 128), K/V (B, Smax, Hkv, 128), all
// bf16 and contiguous, K/V 16-byte aligned; pos int64, (B,) with
// pos_stride 1 or a scalar with 0; part f32 scratch of
// B*Hkv*nsplit*G*(128 + 2); tickets int32 (B*Hkv), all 0; out (B, Hq, 128).
extern "C" int da_decode_bf16(const void* q, const void* k_new, const void* v_new, void* K,
                              void* V, const void* pos, int pos_stride, void* part,
                              void* tickets, void* out, int B, int Smax, int Hkv, int G,
                              int chunk, int nsplit, float scale, void* stream) {
  if (G < 1 || G > MAX_G || chunk % TILE || nsplit * chunk < Smax) return (int)cudaErrorInvalidValue;
  cudaError_t e = sm90::set_smem_once(reinterpret_cast<const void*>(da_kernel), SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  Args a;
  a.q = static_cast<const bf16*>(q);
  a.k_new = static_cast<const bf16*>(k_new);
  a.v_new = static_cast<const bf16*>(v_new);
  a.K = static_cast<bf16*>(K);
  a.V = static_cast<bf16*>(V);
  a.pos = static_cast<const long long*>(pos);
  a.pos_stride = pos_stride;
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<int*>(tickets);
  a.out = static_cast<bf16*>(out);
  a.Smax = Smax;
  a.Hkv = Hkv;
  a.G = G;
  a.chunk = chunk;
  a.nsplit = nsplit;
  a.scale = scale;
  da_kernel<<<dim3(nsplit, Hkv, B), THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
