// Decode attention against a paged KV cache, for Hopper (sm_90a), split
// over the cache (flash-decoding).
//
// Replaces the TPU kernel _paged_kernel (deepspeed_tpu/ops/
// decode_attention.py:194, launched by decode_attention_paged at :300):
// T_q >= 1 query rows of batch row b attend the keys at logical positions
// [0, lengths[b] + T_q) through the row's block table (logical block j of
// row b lives in pool block tables[b, j] of the [NB, BS, H, D] pools), row r
// seeing keys <= lengths[b] + r — so T_q = k + 1 is the speculative verify
// step unchanged. fp32 online softmax, p rounded to the value dtype before
// P.V (the TPU kernel's p.astype(v.dtype), :226-227), safe divide when
// l == 0.
//
// What bounds it on the H100: the bytes of K and V the visible keys occupy
// (4 D bytes a key and head in bf16 against 4 D flops a key and row): at
// serving's decode step (4 slots, lengths 0/137/602/1000, H=12 D=64) 5.3
// MB, 1.6 us at 3.35 TB/s. What held the first version (one CTA per head,
// batch row and 4 query rows; 29.1 us there) back was too few bytes in
// flight (48 CTAs on 132 SMs, 32 keys in flight each) and a dependent
// global read of the table entry before every key. The design is
// decode_split.cuh's split decode over the paged pools (PagedKeys): the
// grid is split over the cache (ops/decode_attention.py:decode_splits,
// from the shapes alone: the launch never reads the lengths), each CTA
// reads its row's length on the device and copies the table entries of
// its own split into shared memory once, so a key's address is one
// shared-memory read away, each lane group has UNROLL keys' loads in
// flight, and the last CTA of a row group merges the splits in split
// order. A table entry naming the garbage block 0 (or any index outside
// the pool) is never read, so the garbage sink never contributes.

#include "decode_split.cuh"

using namespace dsport;

namespace {

// bf16: two CTAs an SM (128 registers a thread); fp32's raw rows are twice
// as wide, so one. Dynamic shared memory: the split's table entries
template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS, sizeof(T) == 2 ? 2 : 1)
decode_paged_kernel(const T* __restrict__ q, PagedKeys<T, D> keys,
                    T* __restrict__ out, float* __restrict__ ws,
                    int* __restrict__ tickets, int Tq, int H, int splits,
                    int min_split_keys, float scale) {
  extern __shared__ int tbl_s[];
  split_decode<T, D>(q, keys, out, ws, tickets, Tq, H, splits,
                     min_split_keys, scale, tbl_s);
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* tables,
           const int* lengths, void* out, float* ws, int* tickets, int B,
           int Tq, int H, int NB, int BS, int MB, int splits, int min_keys,
           float scale, cudaStream_t stream) {
  const int smem = MB * static_cast<int>(sizeof(int));
  static int granted = 0;
  const int err = grant_smem(decode_paged_kernel<T, D>, smem, granted);
  if (err) return err;
  PagedKeys<T, D> keys;
  set_table(keys, tables, lengths, H, NB, BS, MB);
  keys.k = static_cast<const T*>(kp);
  keys.v = static_cast<const T*>(vp);
  const int groups = (Tq + DEC_ROWS - 1) / DEC_ROWS;
  const dim3 grid(H, B, groups * splits);
  decode_paged_kernel<T, D><<<grid, DEC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), keys, static_cast<T*>(out), ws, tickets, Tq,
      H, splits, min_keys, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* kp, const void* vp,
               const int* tables, const int* lengths, void* out, float* ws,
               int* tickets, int B, int Tq, int H, int D, int NB, int BS,
               int MB, int splits, int min_keys, float scale,
               cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kp, vp, tables, lengths, out, ws, tickets, B, Tq, H, NB, BS, MB, splits, min_keys, scale, s);
    case 32: return launch<T, 32>(q, kp, vp, tables, lengths, out, ws, tickets, B, Tq, H, NB, BS, MB, splits, min_keys, scale, s);
    case 64: return launch<T, 64>(q, kp, vp, tables, lengths, out, ws, tickets, B, Tq, H, NB, BS, MB, splits, min_keys, scale, s);
    case 128: return launch<T, 128>(q, kp, vp, tables, lengths, out, ws, tickets, B, Tq, H, NB, BS, MB, splits, min_keys, scale, s);
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
extern "C" int ds_decode_paged(const void* q, const void* k_pool,
                               const void* v_pool, const void* block_tables,
                               const void* lengths, void* out,
                               void* workspace, void* tickets, int is_bf16,
                               int B, int Tq, int H, int D, int NB, int BS,
                               int MB, int splits, int min_split_keys,
                               float scale, void* stream) {
  if (!split_args_ok(Tq, splits, MB * BS, min_split_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(workspace);
  int* tk = static_cast<int*>(tickets);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k_pool, v_pool, t, ln, out, w, tk, B,
                                     Tq, H, D, NB, BS, MB, splits,
                                     min_split_keys, scale, s);
  return dispatch_d<float>(q, k_pool, v_pool, t, ln, out, w, tk, B, Tq, H,
                           D, NB, BS, MB, splits, min_split_keys, scale, s);
}
