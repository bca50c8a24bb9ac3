// Decode attention against an append KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel _kernel (deepspeed_tpu/ops/decode_attention.py:39,
// launched by decode_attention at :135): T_q query rows per batch row attend
// the valid prefix [0, idx + T_q) of the [B, S, H, D] append cache, row r
// seeing keys <= idx + r, fp32 online softmax, p rounded to the value dtype
// before P.V, safe divide when l == 0.
//
// What bounds it on the H100: the bytes of K and V below idx + T_q (see
// decode_common.cuh); the design reads only those keys, in 16-byte vectors.
// idx is read from a 0-d int32 device tensor, so the host never syncs on it
// and a CUDA-graph capture later needs no change. S need not be a multiple
// of any block size (the TPU wrapper requires S % block_k == 0).
//
// One block per (head, batch row, group of DEC_ROWS query rows).

#include "decode_common.cuh"

using namespace dsport;

namespace {

template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS)
decode_append_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc, const int* __restrict__ index,
                     T* __restrict__ out, int Tq, int H, int S, float scale) {
  const int h = blockIdx.x, b = blockIdx.y, r0 = blockIdx.z * DEC_ROWS;
  const int idx = *index;
  const int n_keys = min(idx + min(r0 + DEC_ROWS, Tq), S);
  const long long row_stride = (long long)H * D;
  const long long qo = ((long long)b * Tq * H + h) * D;
  auto key_row = [=](int j) -> long long {
    return (((long long)b * S + j) * H + h) * D;
  };
  decode_block<T, D>(q + qo, kc, vc, out + qo, row_stride, Tq, r0, idx,
                     n_keys, scale, key_row);
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const int* index,
           void* out, int B, int Tq, int H, int S, float scale,
           cudaStream_t stream) {
  const dim3 grid(H, B, (Tq + DEC_ROWS - 1) / DEC_ROWS);
  decode_append_kernel<T, D><<<grid, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), index, static_cast<T*>(out), Tq, H, S,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* kc, const void* vc,
               const int* index, void* out, int B, int Tq, int H, int D,
               int S, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kc, vc, index, out, B, Tq, H, S, scale, s);
    case 32: return launch<T, 32>(q, kc, vc, index, out, B, Tq, H, S, scale, s);
    case 64: return launch<T, 64>(q, kc, vc, index, out, B, Tq, H, S, scale, s);
    case 128: return launch<T, 128>(q, kc, vc, index, out, B, Tq, H, S, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaGetLastError() code of the launch (0 = launched).
extern "C" int ds_decode_append(const void* q, const void* k_cache,
                                const void* v_cache, const void* cache_index,
                                void* out, int is_bf16, int B, int Tq, int H,
                                int D, int S, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(cache_index);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k_cache, v_cache, idx, out, B, Tq, H,
                                     D, S, scale, s);
  return dispatch_d<float>(q, k_cache, v_cache, idx, out, B, Tq, H, D, S,
                           scale, s);
}
