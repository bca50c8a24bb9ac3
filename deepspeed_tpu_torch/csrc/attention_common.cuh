// Shared helpers of the port's attention kernels (flash_fwd.cu,
// flash_fwd_sm90.cu, flash_bwd_dq.cu, flash_bwd_dkv.cu, decode_append.cu,
// decode_paged.cu, decode_paged_int8.cu, block_sparse_fwd.cu,
// block_sparse_bwd_dq.cu, block_sparse_bwd_dkv.cu):
// element conversions, the rounding point of the TPU kernels, strides
// passed by value, and vector loads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dsport {

// the TPU kernels' mask value: finite, so exp(NEG_INF - NEG_INF) stays 1
// and the running max never turns into NaN
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// p.astype(v.dtype) in the TPU kernels: the unnormalized probability is
// rounded to the value dtype before it multiplies V
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// element strides handed to a kernel by value (kernel parameters, no
// device copy): N int64 from the caller's host array
template <int N>
struct Strides {
  long long v[N];
};

template <int N>
inline Strides<N> load_strides(const void* host) {
  Strides<N> s;
  const long long* p = static_cast<const long long*>(host);
  for (int i = 0; i < N; ++i) s.v[i] = p[i];
  return s;
}

// the block-sparse kernels' shapes (block_sparse_*.cu): head dim D, square
// blocks that are a multiple of 16 in [16, 256] and divide both lengths
inline bool sparse_shape_ok(int head_dim, int D, int block, int Sq, int Sk) {
  return head_dim == D && block >= 16 && block <= 256 && block % 16 == 0 &&
         Sq % block == 0 && Sk % block == 0;
}

// 8 consecutive elements starting at p (16-byte aligned for bf16,
// 32-byte aligned for fp32) into fp32 registers
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

}  // namespace dsport
