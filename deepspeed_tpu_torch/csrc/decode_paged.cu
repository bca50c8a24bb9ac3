// Decode attention against a paged KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel _paged_kernel (deepspeed_tpu/ops/
// decode_attention.py:194, launched by decode_attention_paged at :300):
// T_q >= 1 query rows of batch row b attend the keys at logical positions
// [0, lengths[b] + T_q) through the row's block table (logical block j of
// row b lives in pool block tables[b, j] of the [NB, BS, H, D] pools), row r
// seeing keys <= lengths[b] + r — so T_q = k + 1 is the speculative verify
// step unchanged. fp32 online softmax, p rounded to the value dtype before
// P.V, safe divide when l == 0.
//
// What bounds it on the H100: the bytes of K and V the visible keys occupy
// (see decode_common.cuh). The block reads lengths[b] and tables[b, j]
// itself and visits only logical blocks with j*BS < lengths[b] + T_q; a table
// entry naming the garbage block 0 (or any index outside the pool) is never
// read, so the garbage sink never contributes.
//
// One block per (head, batch row, group of DEC_ROWS query rows).

#include "decode_common.cuh"

using namespace dsport;

namespace {

constexpr int GARBAGE_BLOCK = 0;

template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS)
decode_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int Tq, int H, int NB, int BS, int MB, float scale) {
  const int h = blockIdx.x, b = blockIdx.y, r0 = blockIdx.z * DEC_ROWS;
  const int len = lengths[b];
  const int n_keys = min(len + min(r0 + DEC_ROWS, Tq), MB * BS);
  const int* table = tables + (long long)b * MB;
  const long long row_stride = (long long)H * D;
  const long long qo = ((long long)b * Tq * H + h) * D;
  auto key_row = [=](int j) -> long long {
    const int blk = table[j / BS];
    if (blk <= GARBAGE_BLOCK || blk >= NB) return -1;
    return (((long long)blk * BS + j % BS) * H + h) * D;
  };
  decode_block<T, D>(q + qo, kp, vp, out + qo, row_stride, Tq, r0, len,
                     n_keys, scale, key_row);
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lengths, void* out, int B, int Tq, int H, int NB,
           int BS, int MB, float scale, cudaStream_t stream) {
  const dim3 grid(H, B, (Tq + DEC_ROWS - 1) / DEC_ROWS);
  decode_paged_kernel<T, D><<<grid, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lengths, static_cast<T*>(out), Tq,
      H, NB, BS, MB, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* kp, const void* vp,
               const int* tables, const int* lengths, void* out, int B,
               int Tq, int H, int D, int NB, int BS, int MB, float scale,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kp, vp, tables, lengths, out, B, Tq, H, NB, BS, MB, scale, s);
    case 32: return launch<T, 32>(q, kp, vp, tables, lengths, out, B, Tq, H, NB, BS, MB, scale, s);
    case 64: return launch<T, 64>(q, kp, vp, tables, lengths, out, B, Tq, H, NB, BS, MB, scale, s);
    case 128: return launch<T, 128>(q, kp, vp, tables, lengths, out, B, Tq, H, NB, BS, MB, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaGetLastError() code of the launch (0 = launched).
extern "C" int ds_decode_paged(const void* q, const void* k_pool,
                               const void* v_pool, const void* block_tables,
                               const void* lengths, void* out, int is_bf16,
                               int B, int Tq, int H, int D, int NB, int BS,
                               int MB, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k_pool, v_pool, t, ln, out, B, Tq, H,
                                     D, NB, BS, MB, scale, s);
  return dispatch_d<float>(q, k_pool, v_pool, t, ln, out, B, Tq, H, D, NB,
                           BS, MB, scale, s);
}
