// Decode attention against an append KV cache, for Hopper (sm_90a), split
// over the cache (flash-decoding).
//
// Replaces the TPU kernel _kernel (deepspeed_tpu/ops/decode_attention.py:39,
// launched by decode_attention at :135): T_q query rows per batch row attend
// the valid prefix [0, idx + T_q) of the [B, S, H, D] append cache, row r
// seeing keys <= idx + r, fp32 online softmax, p rounded to the value dtype
// before P.V, safe divide when l == 0. idx is read from a 0-d int32 device
// tensor, so the host never syncs on it and a CUDA-graph capture later
// needs no change. S need not be a multiple of any block size (the TPU
// wrapper requires S % block_k == 0).
//
// A left-padded batch (generate(attention_mask=)) passes `first`, each
// row's pad length as a [B] int32 device tensor: row b sees keys
// [first[b], idx + r], what the JAX model's padded decode computes on its
// plain masked path (deepspeed_tpu/models/gpt2.py:507-516, which skips the
// Pallas kernel). The split decode cuts only those keys, so the pads are
// never read and cost no bytes; a row whose only visible key is its last
// takes one split.
//
// What bounds it on the H100: the bytes of K and V below idx + T_q (4 D
// bytes a key and head in bf16 against 4 D flops a key and row). At B=2
// H=12 S=1024 idx=1000 T_q=1 that is 6.15 MB, 1.84 us at 3.35 TB/s. What
// held the first version back was too few bytes in flight: one CTA per
// (head, batch row, DEC_ROWS query rows) is 24 CTAs on 132 SMs, each
// thread with one 16-byte K and one V load in flight a step, ~192 KB on
// the card, which at ~0.7 us of DRAM latency carries ~0.3 TB/s (23.4 us
// measured). The design is decode_split.cuh's split decode over the
// append cache (AppendKeys: key j of batch row b at row (b S + j) H + h):
// the grid is split over the cache (ops/decode_attention.py:decode_splits,
// from the shapes alone, never idx), each lane group has UNROLL keys' K
// and V loads in flight (32 KB a CTA in bf16, two CTAs an SM), and the
// last CTA of a row group merges the splits' partials in split order, so
// results are bitwise the same from run to run. One launch a call.

#include "decode_split.cuh"

using namespace dsport;

namespace {

// bf16: two CTAs an SM (128 registers a thread); fp32's raw rows are twice
// as wide, so one
template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS, sizeof(T) == 2 ? 2 : 1)
decode_append_kernel(const T* __restrict__ q, AppendKeys<T, D> keys,
                     T* __restrict__ out, float* __restrict__ ws,
                     int* __restrict__ tickets, int Tq, int H, int splits,
                     int min_split_keys, float scale) {
  split_decode<T, D>(q, keys, out, ws, tickets, Tq, H, splits,
                     min_split_keys, scale, nullptr);
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const int* index,
           const int* first, void* out, float* ws, int* tickets, int B,
           int Tq, int H, int S, int splits, int min_keys, float scale,
           cudaStream_t stream) {
  const int groups = (Tq + DEC_ROWS - 1) / DEC_ROWS;
  const dim3 grid(H, B, groups * splits);
  AppendKeys<T, D> keys;
  keys.k = static_cast<const T*>(kc);
  keys.v = static_cast<const T*>(vc);
  keys.index = index;
  keys.first_key = first;
  keys.S = S;
  keys.H = H;
  keys.b_row = 0;
  decode_append_kernel<T, D><<<grid, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), keys, static_cast<T*>(out), ws, tickets, Tq,
      H, splits, min_keys, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* kc, const void* vc,
               const int* index, const int* first, void* out, float* ws,
               int* tickets, int B, int Tq, int H, int D, int S, int splits,
               int min_keys, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kc, vc, index, first, out, ws, tickets, B, Tq, H, S, splits, min_keys, scale, s);
    case 32: return launch<T, 32>(q, kc, vc, index, first, out, ws, tickets, B, Tq, H, S, splits, min_keys, scale, s);
    case 64: return launch<T, 64>(q, kc, vc, index, first, out, ws, tickets, B, Tq, H, S, splits, min_keys, scale, s);
    case 128: return launch<T, 128>(q, kc, vc, index, first, out, ws, tickets, B, Tq, H, S, splits, min_keys, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// workspace: fp32, B * H * ceil(T_q / 4) * splits * 4 * (D + 2) values (a
// split's partial per row: m, l, acc); tickets: int32, B * H * ceil(T_q /
// 4) counters, 0 before the launch and 0 again after it. A row group cuts
// its visible keys into at most `splits` splits of at least
// `min_split_keys` keys (ops/decode_attention.py:MIN_SPLIT_KEYS).
// first_key: null, or B int32 values, each row's first visible key (its
// left-padded prefix; clamped to the row group's keys). Returns
// the cudaGetLastError() code of the launch (0 = launched), or
// cudaErrorInvalidValue for splits outside [1, min(S, 64)], min_split_keys
// below 1 or a grid past 65535 in z.
extern "C" int ds_decode_append(const void* q, const void* k_cache,
                                const void* v_cache, const void* cache_index,
                                const void* first_key, void* out,
                                void* workspace, void* tickets,
                                int is_bf16, int B, int Tq, int H, int D,
                                int S, int splits, int min_split_keys,
                                float scale, void* stream) {
  if (!split_args_ok(Tq, splits, S, min_split_keys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(cache_index);
  const int* first = static_cast<const int*>(first_key);
  float* w = static_cast<float*>(workspace);
  int* t = static_cast<int*>(tickets);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k_cache, v_cache, idx, first, out, w,
                                     t, B, Tq, H, D, S, splits,
                                     min_split_keys, scale, s);
  return dispatch_d<float>(q, k_cache, v_cache, idx, first, out, w, t, B, Tq,
                           H, D, S, splits, min_split_keys, scale, s);
}
