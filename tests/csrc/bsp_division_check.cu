// Card check of the fused bit-serial kernel's division (bitserial_profile.cu:
// rcp_refined, div_by_scale, amax_scale, qbits_amax) against __fdiv_rn.
// For each amax: every finite bf16 x with |x| <= amax, 65536 pseudo-random
// f32 x in [-amax, amax] and the 256 half-integer multiples of s (ties).
// Counts the pairs tested, the quotients that differ, those among them of
// magnitude 2^-24 or more, and the |q| that differ from
// |clamp(rint(__fdiv_rn(x, s)), -128, 127)|.  Built by
// tests/test_torch_gpu.py with -I at the kernels' csrc directory.
#include "bitserial_profile.cu"

namespace {

__device__ __forceinline__ unsigned int mix(unsigned long long i) {
  unsigned long long z = i * 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return (unsigned int)(z ^ (z >> 31));
}

constexpr int PER_AMAX = 65536 * 2 + 256;

__global__ void division_check(const float* amaxes, int n, unsigned long long* counts) {
  unsigned long long tested = 0, differ = 0, differ_large = 0, mag_differ = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < (long long)n * PER_AMAX; i += (long long)gridDim.x * blockDim.x) {
    const float amax = amaxes[i / PER_AMAX];
    const int j = (int)(i % PER_AMAX);
    const float s = amax_scale(amax);
    const float r = rcp_refined(s);
    float x;
    if (j < 65536) {
      x = __uint_as_float((unsigned int)j << 16);
    } else if (j < 2 * 65536) {
      x = __fmul_rn((float)(mix(i) >> 8) * (2.f / 16777216.f) - 1.f, amax);
    } else {
      x = __fmul_rn((float)(j - 2 * 65536 - 128) + 0.5f, s);
    }
    if (!(fabsf(x) <= amax)) continue;
    const float exact = __fdiv_rn(x, s);
    const float fast = div_by_scale(x, s, r);
    ++tested;
    if (__float_as_uint(fast) != __float_as_uint(exact) && !(fast == 0.f && exact == 0.f)) {
      ++differ;
      if (fabsf(exact) >= 5.9604645e-08f) ++differ_large;
    }
    if ((qbits_amax(x, s, r) & 0xffu) != (qbits(rintf(exact), 1.f) & 0xffu)) ++mag_differ;
  }
  atomicAdd(counts, tested);
  atomicAdd(counts + 1, differ);
  atomicAdd(counts + 2, differ_large);
  atomicAdd(counts + 3, mag_differ);
}

}  // namespace

// amaxes: n f32 on the card; counts: 4 zeroed uint64 on the card.
extern "C" int bsp_division_check(const void* amaxes, int n, void* counts) {
  division_check<<<132 * 8, 256>>>(static_cast<const float*>(amaxes), n,
                                   static_cast<unsigned long long*>(counts));
  return (int)cudaDeviceSynchronize();
}
