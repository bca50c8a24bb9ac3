// Per-tensor int8 quantization with stochastic rounding for Hopper (sm_90a).
//
// Replaces the TPU kernel stochastic_quantize_tpu.kernel
// (deepspeed_tpu/ops/quantizer.py:141, launched by pallas_call at :154):
// scale = absmax / 127 (1 where that is 0) over the whole fp32 tensor, and
// q = clip(floor(x / scale + u), -128, 127) with u the top 24 bits of a
// random word times 2^-24. The TPU's PRNG cannot be matched here: u comes
// from Philox4x32-10 keyed by (seed, 0) at counter (i >> 2, 0, 0, 0), word
// i & 3 for element i, so the codes depend on (seed, element index) only
// and equal the plain version's (ops/quantizer.py) bit for bit.
//
// What bounds it on the H100: bytes. Each element is read twice (absmax,
// then the codes) and written once as int8; the least the function needs is
// 4 B read and 1 B written an element at 3.35 TB/s, against ~25 integer
// operations of Philox an element. Design: two launches on the caller's
// stream. Pass 1 is a grid-stride absmax of 16-byte loads, reduced in each
// warp by shuffles and in each block through shared memory, then one
// atomicMax per block on the float's bits into a word the wrapper zeroed
// (non-negative floats order like their bit patterns, and a NaN with its
// sign cleared lies above +inf, so a NaN propagates into the scale as it
// does through max|x|). Pass 2 reads the absmax, writes the scale from
// block 0, and has each thread turn 16 elements (four 16-byte loads, four
// Philox calls) into one 16-byte store of codes; a ragged tail or an
// unaligned input takes the scalar loop. The divide is IEEE (__fdiv_rn),
// as the TPU kernel's x / scale.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 2048;

__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               uint32_t k0) {
  uint32_t c2 = 0, c3 = 0, k1 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint4 philox_at(unsigned long long ctr,
                                           uint32_t seed) {
  return philox4x32_10(static_cast<uint32_t>(ctr),
                       static_cast<uint32_t>(ctr >> 32), seed);
}

__device__ __forceinline__ int8_t code(float x, float scale, uint32_t word) {
  const float u = static_cast<float>(word >> 8) * 5.9604644775390625e-08f;
  const float f = floorf(__fadd_rn(__fdiv_rn(x, scale), u));
  // cvt.rzi saturates +-inf and turns NaN (a NaN scale) into 0, as the
  // TPU kernel's and the plain version's casts do
  const int i = __float2int_rz(f);
  return static_cast<int8_t>(i < -128 ? -128 : i > 127 ? 127 : i);
}

// max that keeps a NaN (fmaxf drops it): a NaN anywhere gives a NaN
// absmax and scale, as max|x| does in the TPU kernel and the plain version
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

__device__ __forceinline__ float absmax4(float4 v) {
  return nan_max(nan_max(fabsf(v.x), fabsf(v.y)),
                 nan_max(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(THREADS)
absmax_kernel(const float* __restrict__ x, long long n,
              unsigned int* __restrict__ absmax_bits) {
  __shared__ float warp_max[THREADS / 32];
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  float m = 0.f;
  long long i0 = 0;
  if (aligned16(x)) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n4 = n / 4;
    for (long long i = tid; i < n4; i += stride) m = nan_max(m, absmax4(x4[i]));
    i0 = n4 * 4;
  }
  for (long long i = i0 + tid; i < n; i += stride) m = nan_max(m, fabsf(x[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x < 32) {
    m = threadIdx.x < THREADS / 32 ? warp_max[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    if (threadIdx.x == 0) atomicMax(absmax_bits, __float_as_uint(m));
  }
}

__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale_out, long long n,
                const unsigned int* __restrict__ absmax_bits,
                uint32_t seed) {
  float scale = __fdiv_rn(__uint_as_float(*absmax_bits), 127.f);
  if (scale == 0.f) scale = 1.f;
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale_out = scale;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS +
                        threadIdx.x;
  long long i0 = 0;
  if (aligned16(x)) {  // q comes from torch.empty: 16-byte aligned
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const long long n16 = n / 16;
    for (long long c = tid; c < n16; c += stride) {
      uint32_t packed[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 v = x4[4 * c + j];
        const uint4 r = philox_at(4 * c + j, seed);
        packed[j] = (static_cast<uint32_t>(static_cast<uint8_t>(code(v.x, scale, r.x)))) |
                    (static_cast<uint32_t>(static_cast<uint8_t>(code(v.y, scale, r.y))) << 8) |
                    (static_cast<uint32_t>(static_cast<uint8_t>(code(v.z, scale, r.z))) << 16) |
                    (static_cast<uint32_t>(static_cast<uint8_t>(code(v.w, scale, r.w))) << 24);
      }
      reinterpret_cast<uint4*>(q)[c] =
          make_uint4(packed[0], packed[1], packed[2], packed[3]);
    }
    i0 = n16 * 16;
  }
  for (long long i = i0 + tid; i < n; i += stride) {
    const uint4 r = philox_at(static_cast<unsigned long long>(i) >> 2, seed);
    const int w = static_cast<int>(i & 3);
    const uint32_t word = w == 0 ? r.x : w == 1 ? r.y : w == 2 ? r.z : r.w;
    q[i] = code(x[i], scale, word);
  }
}

int blocks_for(long long work) {
  const long long b = (work + THREADS - 1) / THREADS;
  return static_cast<int>(b < 1 ? 1 : b > MAX_BLOCKS ? MAX_BLOCKS : b);
}

}  // namespace

// x: n contiguous fp32; q: n int8 (16-byte aligned); scale: one fp32;
// absmax_bits: one uint32 the caller zeroed. Returns the
// cudaGetLastError() code of the launches (0 = launched).
extern "C" int ds_stochastic_quantize(const void* x, void* q, void* scale,
                                      void* absmax_bits, long long n,
                                      unsigned int seed, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  unsigned int* bits = static_cast<unsigned int*>(absmax_bits);
  absmax_kernel<<<blocks_for(n / 4), THREADS, 0, s>>>(xf, n, bits);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  quantize_kernel<<<blocks_for(n / 16), THREADS, 0, s>>>(
      xf, static_cast<int8_t*>(q), static_cast<float*>(scale), n, bits, seed);
  return static_cast<int>(cudaGetLastError());
}
