// Hopper (sm_90a) building blocks shared by block_sparse_matmul.cu,
// intrablock_matmul.cu, flash_attention.cu and decode_attention.cu, which
// include this file; it is not built on its own.  Inline PTX only (no
// CuTe), so each source builds in seconds.
//
// * mbarrier, bulk-copy and TMA (2D and 3D) helpers for rings of
//   shared-memory stages;
// * ldmatrix + mma.sync m16n8k16 helpers for the decode variants, on x
//   tiles with padded rows and weight tiles in TMA's 128-byte swizzle
//   (decode attention uses the first three on tiles of its own);
// * cluster_reduce_store: the split-K sum of f32 partials through
//   distributed shared memory, in rank order, so a result is bitwise
//   repeatable;
// * gemm_prefill<MODE>: the prefill variant of both kernels, a
//   128 x 128 output tile per CTA computed by two consumer warpgroups
//   with wgmma m64n128k16 (f32 accumulators in registers) from a
//   3-stage ring (97 KB, so two CTAs share an SM and one CTA's epilogue
//   overlaps the other's main loop) that one producer thread fills with
//   TMA tensor-map loads (128-byte swizzle), one wgmma group kept in
//   flight behind the next, optionally split over a thread-block cluster
//   along the reduction;
// * tensor-map encoding on the host through libcuda's
//   cuTensorMapEncodeTiled, found with dlsym (no -lcuda at build time),
//   and a table that keeps each map once encoded (cached_map).
#pragma once
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <dlfcn.h>
#include <stdint.h>

namespace sm90 {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// mbarrier, bulk copy, TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive once and raise the barrier's expected transaction bytes.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// Contiguous global → shared copy of `bytes` (a multiple of 16, both ends
// 16-byte aligned) that reports completion to `bar`.
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, uint32_t bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 2D TMA load of the box at (c0 = inner, c1 = outer) coordinates.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// 3D TMA load of the box at (c0 = inner, c1, c2 = outer) coordinates.
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// ---------------------------------------------------------------------------
// mma.sync (decode variants)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7},"
      " {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One warp's share of a 16-row decode tile: rows 0..15 of the x tile `xs`
// (row stride `ldx` elements, k contiguous; 16 bytes off a multiple of 128
// so that ldmatrix's eight rows fall in distinct bank groups) times
// KSTEPS x 16 rows of the weight tile `ws`, columns n0..n0+31, accumulated
// into acc[4][4] (mma.sync C fragments of four n8 tiles).  TMA wrote the
// weight tile with the 128-byte swizzle as two boxes of ROWS rows x 64
// columns (columns 64..127 start ROWS * 128 bytes after columns 0..63):
// the 16-byte chunk c of row k sits at chunk c ^ (k % 8) of its 128-byte
// row, so its ldmatrix reads are free of bank conflicts too.
template <int KSTEPS, int ROWS>
__device__ __forceinline__ void warp_tile_16x32(float (&acc)[4][4], const bf16* xs, int ldx,
                                                   const unsigned char* ws, int n0) {
  const int lane = threadIdx.x & 31, m = lane >> 3, r8 = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, xs + ((m & 1) * 8 + r8) * ldx + kk * 16 + (m >> 1) * 8);
    const int k = kk * 16 + (m & 1) * 8 + r8;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int n = n0 + p * 16 + (m >> 1) * 8;
      uint32_t b[4];
      ldsm_x4_t(b, ws + (n >> 6) * ROWS * 128 + k * 128 + ((((n & 63) >> 3) ^ (k & 7)) << 4));
      mma_bf16(acc[2 * p], a, b[0], b[1]);
      mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
    }
  }
}

// Store a warp's acc (from warp_tile_16x32) into the f32 tile red[16][ldr].
__device__ __forceinline__ void store_warp_tile_16x32(const float (&acc)[4][4], float* red,
                                                      int ldr, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = n0 + 8 * i + 2 * t;
    red[g * ldr + c] = acc[i][0];
    red[g * ldr + c + 1] = acc[i][1];
    red[(g + 8) * ldr + c] = acc[i][2];
    red[(g + 8) * ldr + c + 1] = acc[i][3];
  }
}

// ---------------------------------------------------------------------------
// Split-K reduction through distributed shared memory
// ---------------------------------------------------------------------------

// Every CTA of the cluster holds its f32 partial of one output tile in
// red[rows][ldr] (shared memory).  After a cluster barrier, rank r sums
// the elements of its share of the tile over ranks 0, 1, ..., c-1, in
// that order, and writes them as bf16 to y[row * ldy + col] (y already
// offset to the tile); a second barrier keeps every partial alive until
// all remote reads are done.  All threads of every CTA must call it.
template <int NT>
__device__ __forceinline__ void cluster_reduce_store(float* red, int ldr, int rows, int cols,
                                                     bf16* y, long ldy) {
  cg::cluster_group cl = cg::this_cluster();
  const int c = static_cast<int>(cl.num_blocks()), rank = static_cast<int>(cl.block_rank());
  cl.sync();
  const int E = rows * cols;
  const int lo = rank * E / c, hi = (rank + 1) * E / c;
  for (int e = lo + static_cast<int>(threadIdx.x); e < hi; e += NT) {
    const int r = e / cols, col = e % cols;
    float s = 0.f;
    for (int q = 0; q < c; ++q) s += cl.map_shared_rank(red, q)[r * ldr + col];
    y[r * ldy + col] = __float2bfloat16(s);
  }
  cl.sync();
}

// Live slots of one idx row: a whole warp counts the entries >= 0.
__device__ __forceinline__ int warp_count_live(const int* row, int L) {
  const int lane = threadIdx.x & 31;
  int n = 0;
  for (int b = 0; b < L; b += 32) {
    const int l = b + lane;
    n += __popc(__ballot_sync(0xffffffffu, l < L && __ldg(row + l) >= 0));
  }
  return n;
}

// ---------------------------------------------------------------------------
// wgmma (prefill variants)
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor for a tile written by TMA with the
// 128-byte swizzle (layout type 1); base offset 0 (atoms 1024-byte aligned).
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// D[64 x 128] += A[64 x 16] (K-major) * B[16 x 128] (MN-major), f32 D.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Prefill tile and ring.
constexpr int PM = 128;                    // output rows of a CTA (two m64 warpgroups)
constexpr int PN = 128;                    // output columns of a CTA
constexpr int PK = 64;                     // reduction depth of one stage (128 bytes)
constexpr int PSTAGES = 3;
constexpr int P_A_BYTES = PM * PK * 2;     // 16 KB: x tile, 128 rows x 128 B
constexpr int P_BH_BYTES = PK * 64 * 2;    // 8 KB: one 64-column half of the weight tile
constexpr int P_STAGE_BYTES = P_A_BYTES + 2 * P_BH_BYTES;
constexpr int P_THREADS = 288;             // warpgroups 0-1 consume, warp 8 produces
constexpr int P_LDR = PN + 4;              // f32 partial row stride
constexpr size_t P_SMEM = 1024 + PSTAGES * P_STAGE_BYTES + 2 * PSTAGES * sizeof(uint64_t);
static_assert(PM * P_LDR * 4 <= PSTAGES * P_STAGE_BYTES, "partial must fit in the ring");

// MODE 0 (block-sparse): output tile j is column group j; its reduction
// units are the live slots of idx row j (2 stages each: bm = 128 rows of
// the block in two 64-row halves).  tmA: x (B, K); tmB: w_comp viewed as
// (Gn*L*128, 128).
// MODE 1 (dense chunks): output tile j is columns j*128..+127 of a (Kc, N)
// weight; its units are the 64-row chunks of Kc (1 stage each).  tmA:
// the gathered x (B, Kp); tmB: w_comp (Kc, N).
// Grid (cluster, column tiles, row tiles), cluster (cluster, 1, 1): rank
// r of the cluster takes units [r*n/c, (r+1)*n/c) of its tile.  Rows past
// B and reduction rows past the tensors' ends arrive as zeros (TMA
// out-of-bounds fill).
template <int MODE>
__global__ void __launch_bounds__(P_THREADS, 2)
gemm_prefill(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
             const int* __restrict__ idx, bf16* __restrict__ y, int B, int N, int L) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + PSTAGES * P_STAGE_BYTES);
  uint64_t* empty = full + PSTAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = gridDim.x, rank = blockIdx.x;
  const int j = blockIdx.y, m0 = blockIdx.z * PM;
  const int* row = idx + static_cast<long>(j) * L;

  if (tid == 0) {
    for (int s = 0; s < PSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 256);
    }
    fence_mbar_init();
  }
  __syncthreads();

  int units = L;                                  // MODE 1: L is the chunk count
  if (MODE == 0) units = warp_count_live(row, L);
  const int lo = rank * units / c, hi = (rank + 1) * units / c;
  const int per_unit = MODE == 0 ? 2 : 1;
  const int nsteps = (hi - lo) * per_unit;

  if (warp == 8) {
    // ---- producer: one lane issues the TMA loads of every stage ----------
    auto issue = [&](int s, int kcol, int brow, int bcol) {
      const int st = s % PSTAGES;
      if (s >= PSTAGES) mbar_wait(&empty[st], ((s / PSTAGES) - 1) & 1);
      unsigned char* base = ring + st * P_STAGE_BYTES;
      mbar_arrive_expect_tx(&full[st], P_STAGE_BYTES);
      tma_2d(base, &tmA, kcol, m0, &full[st]);
      tma_2d(base + P_A_BYTES, &tmB, bcol, brow, &full[st]);
      tma_2d(base + P_A_BYTES + P_BH_BYTES, &tmB, bcol + 64, brow, &full[st]);
    };
    if (MODE == 0) {
      int o = 0, s = 0;
      for (int b = 0; b < L && o < hi; b += 32) {
        const int l = b + lane;
        const int v = l < L ? __ldg(row + l) : -1;
        unsigned live = __ballot_sync(0xffffffffu, v >= 0);
        while (live) {
          const int bit = __ffs(live) - 1;
          live &= live - 1;
          const int kb = __shfl_sync(0xffffffffu, v, bit);
          if (o >= lo && o < hi && lane == 0) {
            const int brow = (j * L + b + bit) * 128;
            issue(s, kb * 128, brow, 0);
            issue(s + 1, kb * 128 + 64, brow + 64, 0);
          }
          if (o >= lo && o < hi) s += 2;
          ++o;
        }
      }
    } else if (lane == 0) {
      for (int s = 0; s < nsteps; ++s) issue(s, (lo + s) * PK, (lo + s) * PK, j * PN);
    }
    __syncwarp();   // the whole warp reaches the cluster barrier together
  } else if (warp < 8) {
    // ---- consumers: warpgroup wg computes rows wg*64..+63 ----------------
    const int wg = warp >> 2;
    float d[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] = 0.f;
    // one wgmma group stays in flight: stage s-1 is released once the
    // group of stage s has been issued and that of s-1 has completed
    for (int s = 0; s < nsteps; ++s) {
      const int st = s % PSTAGES;
      mbar_wait(&full[st], (s / PSTAGES) & 1);
      unsigned char* base = ring + st * P_STAGE_BYTES;
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PK / 16; ++kk) {
        const uint64_t da = desc_sw128(base + wg * 64 * 128 + kk * 32, 16, 1024);
        const uint64_t db = desc_sw128(base + P_A_BYTES + kk * 16 * 128, P_BH_BYTES, 1024);
        wgmma_m64n128k16(d, da, db);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(d);
      if (s > 0) mbar_arrive(&empty[(s - 1) % PSTAGES]);
    }
    wgmma_wait<0>();
    fence_regs(d);
    // every consumer is done with the ring before it becomes the partial
    asm volatile("bar.sync 1, 256;" ::: "memory");
    float* red = reinterpret_cast<float*>(ring);
    const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      red[r0 * P_LDR + 8 * i + c0] = d[4 * i];
      red[r0 * P_LDR + 8 * i + c0 + 1] = d[4 * i + 1];
      red[(r0 + 8) * P_LDR + 8 * i + c0] = d[4 * i + 2];
      red[(r0 + 8) * P_LDR + 8 * i + c0 + 1] = d[4 * i + 3];
    }
  }
  const int rows = min(PM, B - m0);
  const int cols = min(PN, N - j * PN);
  cluster_reduce_store<P_THREADS>(reinterpret_cast<float*>(ring), P_LDR, rows, cols,
                                  y + static_cast<long>(m0) * N + j * PN, N);
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (h) fn = reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// Tensor map of a row-major bf16 matrix (outer rows, inner columns, row
// stride ld elements) read in boxes of box_outer x 64 with the 128-byte
// swizzle; out-of-bounds elements read as zero.
inline bool encode_bf16_2d(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
                           uint64_t ld, uint32_t box_outer) {
  EncodeTiledFn fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {ld * 2};
  const cuuint32_t box[2] = {64, box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Tensor map of a bf16 array (d0 inner, d1, d2 outer; strides s1, s2 in
// elements) read in boxes of 64 x b1 x b2 with the 128-byte swizzle: the
// box lands in shared memory as b1 * b2 rows of 128 bytes, d1 fastest.
inline bool encode_bf16_3d(CUtensorMap* map, const void* ptr, uint64_t d0, uint64_t d1,
                           uint64_t d2, uint64_t s1, uint64_t s2, uint32_t b1, uint32_t b2) {
  EncodeTiledFn fn = encode_fn();
  if (!fn) return false;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1 * 2, s2 * 2};
  const cuuint32_t box[3] = {64, b1, b2};
  const cuuint32_t estr[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// Raise a kernel's dynamic shared-memory limit once per (kernel, device),
// so that a launch costs the host no attribute call after the first.
inline cudaError_t set_smem_once(const void* kernel, size_t smem) {
  static const void* done_k[64];
  static int done_d[64];
  static int n = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  for (int i = 0; i < n; ++i)
    if (done_k[i] == kernel && done_d[i] == dev) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
  if (e == cudaSuccess && n < 64) {
    done_k[n] = kernel;
    done_d[n++] = dev;
  }
  return e;
}

// The tensor map of encode_bf16_2d for these arguments, copied into *out;
// encoded once and then kept in a direct-mapped table.  A map holds only
// an address, the shape, the row stride and the box, so an entry stays
// right for any tensor later found at the same address with the same
// shape: a decode step finds every weight's map here and encodes nothing.
// The map is copied out because a later lookup may evict its entry.  The
// callers hold Python's GIL (the libraries are loaded with ctypes.PyDLL),
// which serialises access to the table.
inline bool cached_map(CUtensorMap* out, const void* ptr, uint64_t inner, uint64_t outer,
                       uint64_t ld, uint32_t box_outer) {
  struct Entry {
    CUtensorMap map;
    const void* ptr;
    uint64_t inner, outer, ld;
    uint32_t box;
    bool used;
  };
  static Entry table[4096];
  const uint64_t h = (reinterpret_cast<uintptr_t>(ptr) >> 4) * 0x9E3779B97F4A7C15ull ^
                     (inner * 0xBF58476D1CE4E5B9ull) ^ (outer << 20) ^ box_outer;
  Entry& e = table[(h * 0x94D049BB133111EBull) >> 52];
  if (!(e.used && e.ptr == ptr && e.inner == inner && e.outer == outer && e.ld == ld &&
        e.box == box_outer)) {
    e.used = encode_bf16_2d(&e.map, ptr, inner, outer, ld, box_outer);
    if (!e.used) return false;
    e.ptr = ptr;
    e.inner = inner;
    e.outer = outer;
    e.ld = ld;
    e.box = box_outer;
  }
  *out = e.map;
  return true;
}

// Launch `kernel` on a grid whose x dimension is one cluster.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                           cudaStream_t st, Args... args) {
  cudaError_t e = set_smem_once(reinterpret_cast<const void*>(kernel), smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The prefill product: grid (cluster, column tiles, ceil(B/128) row tiles).
template <int MODE>
cudaError_t launch_prefill(const CUtensorMap& a, const CUtensorMap& b, const int* idx, bf16* y,
                           int B, int N, int L, int cluster, int col_tiles, cudaStream_t st) {
  dim3 grid(cluster, col_tiles, (B + PM - 1) / PM);
  return launch_cluster(gemm_prefill<MODE>, grid, P_THREADS, P_SMEM, st, a, b, idx, y, B, N, L);
}

}  // namespace sm90
