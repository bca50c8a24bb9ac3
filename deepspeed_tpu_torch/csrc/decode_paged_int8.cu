// Paged attention over an int8 KV cache, for Hopper (sm_90a), split over
// the cache (flash-decoding): the decode and verify steps, and the prefill
// chunks that decode_paged_int8_sm90.cu does not take.
//
// Replaces the TPU kernel _paged_int8_kernel (deepspeed_tpu/ops/
// decode_attention.py:319, launched by decode_attention_paged_int8 at :425):
// T_q >= 1 query rows of batch row b attend the keys at logical positions
// [0, lengths[b] + T_q) through the row's block table, row r seeing keys
// <= lengths[b] + r (decode, prefill chunk and speculative verify alike).
// The pools hold int8 codes [NB, BS, H, D]; the side pools one fp32 scale
// per (token, head) [NB, BS, H, 1], written by quantize_rowwise.
//
// Rounding points are the TPU kernel's (:334-357), not the bf16 paged
// kernel's: q in fp32, the logit (q . codes) * k_scale * scale, an fp32
// online softmax, p * v_scale kept in fp32 for P.V, and a safe divide when
// l == 0 (the TPU kernel's codes x scale in the other fp32 order).
//
// What bounds it on the H100: the bytes of the visible keys' codes and
// scales (2 D + 8 bytes a key and head), half the bf16 kernel's: at the
// decode step (4 slots, lengths 0/137/602/1000, H=12 D=64) 2.8 MB, 0.85 us
// at 3.35 TB/s. What held the first version (one CTA per head, batch row
// and 4 query rows; 19.0 us there) back was too few bytes in flight and a
// dependent global read of the table entry before every key. The design is
// decode_split.cuh's split decode over the int8 pools (PagedInt8Keys: 8
// codes a lane, D / 8 lanes a key, one fp32 scale a key for K and one for
// V; two CTAs an SM): the grid is split over the cache (ops/
// decode_attention.py:decode_splits, from the shapes alone: the launch
// never reads the lengths), each CTA copies the table entries of its own
// split into shared memory once, each lane group has UNROLL keys' loads in
// flight, and the last CTA of a row group merges the splits in split
// order. A table entry naming the garbage block 0 (or any index outside
// the pool) is never read. fp32 q runs the same kernel.

#include "decode_split.cuh"

using namespace dsport;

namespace {

// two CTAs an SM (128 registers a thread: 8 codes a lane); dynamic shared
// memory: the split's table entries
template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS, 2)
decode_paged_int8_kernel(const T* __restrict__ q, PagedInt8Keys<D> keys,
                         T* __restrict__ out, float* __restrict__ ws,
                         int* __restrict__ tickets, int Tq, int H, int splits,
                         int min_split_keys, float scale) {
  extern __shared__ int tbl_s[];
  split_decode<T, D>(q, keys, out, ws, tickets, Tq, H, splits,
                     min_split_keys, scale, tbl_s);
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int* tables, const int* lengths, void* out,
           float* ws, int* tickets, int B, int Tq, int H, int NB, int BS,
           int MB, int splits, int min_keys, float scale,
           cudaStream_t stream) {
  const int smem = MB * static_cast<int>(sizeof(int));
  static int granted = 0;
  const int err = grant_smem(decode_paged_int8_kernel<T, D>, smem, granted);
  if (err) return err;
  PagedInt8Keys<D> keys;
  set_table(keys, tables, lengths, H, NB, BS, MB);
  keys.k = static_cast<const int8_t*>(kp);
  keys.v = static_cast<const int8_t*>(vp);
  keys.k_scale = static_cast<const float*>(ks);
  keys.v_scale = static_cast<const float*>(vs);
  const int groups = (Tq + DEC_ROWS - 1) / DEC_ROWS;
  const dim3 grid(H, B, groups * splits);
  decode_paged_int8_kernel<T, D><<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), keys, static_cast<T*>(out), ws, tickets, Tq,
      H, splits, min_keys, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* kp, const void* vp, const void* ks,
               const void* vs, const int* tables, const int* lengths,
               void* out, float* ws, int* tickets, int B, int Tq, int H,
               int D, int NB, int BS, int MB, int splits, int min_keys,
               float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kp, vp, ks, vs, tables, lengths, out, ws, tickets, B, Tq, H, NB, BS, MB, splits, min_keys, scale, s);
    case 32: return launch<T, 32>(q, kp, vp, ks, vs, tables, lengths, out, ws, tickets, B, Tq, H, NB, BS, MB, splits, min_keys, scale, s);
    case 64: return launch<T, 64>(q, kp, vp, ks, vs, tables, lengths, out, ws, tickets, B, Tq, H, NB, BS, MB, splits, min_keys, scale, s);
    case 128: return launch<T, 128>(q, kp, vp, ks, vs, tables, lengths, out, ws, tickets, B, Tq, H, NB, BS, MB, splits, min_keys, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// workspace and tickets as ds_decode_append's (B * H * ceil(T_q / 4) row
// groups of `splits` partials; the counters 0 before and after). A row
// group cuts its visible keys into at most `splits` splits of at least
// `min_split_keys` keys. Returns the cudaGetLastError() code of the
// launch (0 = launched), or cudaErrorInvalidValue for splits outside [1,
// min(MB * BS, 64)], min_split_keys below 1, a grid past 65535 in z or a
// table too long for shared memory.
extern "C" int ds_decode_paged_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lengths, void* out, void* workspace, void* tickets,
    int is_bf16, int B, int Tq, int H, int D, int NB, int BS, int MB,
    int splits, int min_split_keys, float scale, void* stream) {
  if (!split_args_ok(Tq, splits, MB * BS, min_split_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(workspace);
  int* tk = static_cast<int*>(tickets);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, t,
                                     ln, out, w, tk, B, Tq, H, D, NB, BS, MB,
                                     splits, min_split_keys, scale, s);
  return dispatch_d<float>(q, k_pool, v_pool, k_scale, v_scale, t, ln, out,
                           w, tk, B, Tq, H, D, NB, BS, MB, splits,
                           min_split_keys, scale, s);
}
