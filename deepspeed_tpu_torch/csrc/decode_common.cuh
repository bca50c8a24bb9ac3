// The decode-attention block shared by decode_append.cu and decode_paged.cu
// (decode_paged_int8.cu takes its constants and its structure):
// up to DEC_ROWS query rows of one (batch row, head) attend the keys at
// logical positions [0, n_keys), query row r seeing keys j <= base + r.
//
// Decode moves K/V bytes and does little arithmetic (4*D flops per key and
// row against 4*D bytes of bf16 K and V), so the bound is memory
// bandwidth. Keys spread over the block's 256 threads: D/8 lanes read one
// key's head row as one 16-byte vector each (bf16), so a warp has 32/(D/8)
// keys in flight and neighbouring lanes read neighbouring bytes. Each lane
// group keeps its own fp32 online-softmax state (m, l, acc) over the keys
// it visits; the dot product is reduced across the group with shuffles,
// and the groups' states merge through shared memory at the end.
#pragma once

#include "attention_common.cuh"

namespace dsport {

constexpr int DEC_THREADS = 256;
constexpr int DEC_ROWS = 4;  // query rows per block; grid.z covers T_q
constexpr int VEC = 8;       // head-dim elements per lane per key

// KeyRow: functor j -> element offset of key j's (head h) row in the K/V
// buffers, or -1 when the key must not be read (a garbage-block entry).
template <typename T, int D, typename KeyRow>
__device__ __forceinline__ void decode_block(
    const T* __restrict__ q, const T* __restrict__ k_buf,
    const T* __restrict__ v_buf, T* __restrict__ out, long long row_stride,
    int tq, int r0, int base, int n_keys, float scale, KeyRow key_row) {
  constexpr int G = D / VEC;                // lanes per key
  constexpr int GROUPS = DEC_THREADS / G;   // keys in flight per block
  __shared__ float m_s[GROUPS][DEC_ROWS];
  __shared__ float l_s[GROUPS][DEC_ROWS];
  __shared__ float acc_s[GROUPS][DEC_ROWS][D];

  const int tid = threadIdx.x;
  const int g = tid / G;
  const int e0 = (tid % G) * VEC;

  float qv[DEC_ROWS][VEC];
  float m[DEC_ROWS], l[DEC_ROWS], acc[DEC_ROWS][VEC];
#pragma unroll
  for (int r = 0; r < DEC_ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) { acc[r][e] = 0.f; qv[r][e] = 0.f; }
    if (r0 + r < tq) load8(q + (r0 + r) * row_stride + e0, qv[r]);
  }

  // every lane runs the same trip count, so the group shuffles below are
  // never divergent; out-of-range keys only switch their update off
  for (int jb = 0; jb < n_keys; jb += GROUPS) {
    const int j = jb + g;
    const long long kr = j < n_keys ? key_row(j) : -1;
    float kv[VEC], vv[VEC];
    if (kr >= 0) {
      load8(k_buf + kr + e0, kv);
      load8(v_buf + kr + e0, vv);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) { kv[e] = 0.f; vv[e] = 0.f; }
    }
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) part += qv[r][e] * kv[e];
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (kr >= 0 && r0 + r < tq && j <= base + r0 + r) {
        const float s = part * scale;
        const float m_new = fmaxf(m[r], s);
        const float alpha = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        l[r] = alpha * l[r] + p;
        const float pv = round_to<T>(p);  // p.astype(v.dtype)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[r][e] = alpha * acc[r][e] + pv * vv[e];
        m[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < DEC_ROWS; ++r) {
    if (e0 == 0) {
      m_s[g][r] = m[r];
      l_s[g][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc_s[g][r][e0 + e] = acc[r][e];
  }
  __syncthreads();
  for (int i = tid; i < DEC_ROWS * D; i += DEC_THREADS) {
    const int r = i / D, d = i % D;
    if (r0 + r >= tq) continue;
    float mx = NEG_INF;
    for (int gg = 0; gg < GROUPS; ++gg) mx = fmaxf(mx, m_s[gg][r]);
    float lsum = 0.f, o = 0.f;
    for (int gg = 0; gg < GROUPS; ++gg) {
      const float w = expf(m_s[gg][r] - mx);
      lsum += w * l_s[gg][r];
      o += w * acc_s[gg][r][d];
    }
    const float safe_l = lsum == 0.f ? 1.f : lsum;  // safe divide, as :79
    out[(r0 + r) * row_stride + d] = from_float<T>(o / safe_l);
  }
}

}  // namespace dsport
