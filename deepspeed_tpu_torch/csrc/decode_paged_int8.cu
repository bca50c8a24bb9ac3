// Paged attention over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernel _paged_int8_kernel (deepspeed_tpu/ops/
// decode_attention.py:319, launched by decode_attention_paged_int8 at :425):
// T_q >= 1 query rows of batch row b attend the keys at logical positions
// [0, lengths[b] + T_q) through the row's block table, row r seeing keys
// <= lengths[b] + r (decode, prefill chunk and speculative verify alike).
// The pools hold int8 codes [NB, BS, H, D]; the side pools one fp32 scale
// per (token, head) [NB, BS, H, 1], written by quantize_rowwise.
//
// Rounding points are the TPU kernel's, not the bf16 paged kernel's: q is
// cast to fp32, K and V are dequantized to fp32 (code x scale), the
// softmax is an fp32 online softmax, p stays fp32 for P.V, and the divide
// is safe when l == 0. K's scale multiplies the dot product of the codes
// ((q . k_codes) * k_scale) and V's scale folds into p (p * v_scale): the
// same products in another fp32 order.
//
// What bounds it on the H100: the bytes of the visible keys' codes and
// scales (2 * D + 8 bytes per key and head), half the bf16 kernel's. The
// structure is decode_common.cuh's: D/16 lanes read one key's head row as
// one 16-byte vector of 16 codes each (4 lanes at D = 64), so a block of
// 256 threads has 256/(D/16) keys in flight; each lane group keeps its
// own fp32 online-softmax state over the keys it visits, the dot product
// is reduced across the group with shuffles, the groups of a warp merge
// with shuffles, and the warps merge through shared memory at the end.
// The block reads lengths[b] and tables[b, j] itself and visits only keys
// j < lengths[b] + T_q; a table entry naming the garbage block 0 (or any
// index outside the pool) is never read.
//
// One block per (head, batch row, group of DEC_ROWS query rows): a chunk
// of T_q rows reads the visible K/V T_q / DEC_ROWS times.

#include <cstdint>

#include "decode_common.cuh"

using namespace dsport;

namespace {

constexpr int GARBAGE_BLOCK = 0;
constexpr int CODES = 16;  // int8 codes per lane per key: one 16-byte load

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  load8(p, out);
  load8(p + 8, out + 8);
}

__device__ __forceinline__ void load16(const float* p, float* out) {
  load8(p, out);
  load8(p + 8, out + 8);
}

__device__ __forceinline__ float code(const uint4& raw, int e) {
  return static_cast<float>(reinterpret_cast<const int8_t*>(&raw)[e]);
}

template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS)
decode_paged_int8_kernel(const T* __restrict__ q,
                         const int8_t* __restrict__ kp,
                         const int8_t* __restrict__ vp,
                         const float* __restrict__ ks,
                         const float* __restrict__ vs,
                         const int* __restrict__ tables,
                         const int* __restrict__ lengths, T* __restrict__ out,
                         int Tq, int H, int NB, int BS, int MB, float scale) {
  constexpr int G = D / CODES;               // lanes per key
  constexpr int GROUPS = DEC_THREADS / G;    // keys in flight per block
  constexpr int WARPS = DEC_THREADS / 32;
  __shared__ float m_s[WARPS][DEC_ROWS];
  __shared__ float l_s[WARPS][DEC_ROWS];
  __shared__ float acc_s[WARPS][DEC_ROWS][D];

  const int h = blockIdx.x, b = blockIdx.y, r0 = blockIdx.z * DEC_ROWS;
  const int len = lengths[b];
  const int n_keys = min(len + min(r0 + DEC_ROWS, Tq), MB * BS);
  const int* table = tables + (long long)b * MB;
  const long long row_stride = (long long)H * D;
  const long long qo = ((long long)b * Tq * H + h) * D;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = tid / G;
  const int e0 = (tid % G) * CODES;

  float qv[DEC_ROWS][CODES];
  float m[DEC_ROWS], l[DEC_ROWS], acc[DEC_ROWS][CODES];
#pragma unroll
  for (int r = 0; r < DEC_ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < CODES; ++e) { acc[r][e] = 0.f; qv[r][e] = 0.f; }
    if (r0 + r < Tq) load16(q + qo + (r0 + r) * row_stride + e0, qv[r]);
  }

  // every lane runs the same trip count, so the group shuffles below are
  // never divergent; out-of-range keys only switch their update off
  for (int jb = 0; jb < n_keys; jb += GROUPS) {
    const int j = jb + g;
    long long kr = -1;  // (token, head) row of key j in the pools
    if (j < n_keys) {
      const int blk = table[j / BS];
      if (blk > GARBAGE_BLOCK && blk < NB)
        kr = ((long long)blk * BS + j % BS) * H + h;
    }
    uint4 kc = make_uint4(0u, 0u, 0u, 0u), vc = kc;
    float k_sc = 0.f, v_sc = 0.f;
    if (kr >= 0) {
      kc = *reinterpret_cast<const uint4*>(kp + kr * D + e0);
      vc = *reinterpret_cast<const uint4*>(vp + kr * D + e0);
      k_sc = ks[kr];
      v_sc = vs[kr];
    }
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < CODES; ++e) part += qv[r][e] * code(kc, e);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (kr >= 0 && r0 + r < Tq && j <= len + r0 + r) {
        const float s = part * k_sc * scale;
        const float m_new = fmaxf(m[r], s);
        const float alpha = expf(m[r] - m_new);
        const float p = expf(s - m_new);
        l[r] = alpha * l[r] + p;
        const float pv = p * v_sc;  // p stays fp32: no rounding to a dtype
#pragma unroll
        for (int e = 0; e < CODES; ++e)
          acc[r][e] = alpha * acc[r][e] + pv * code(vc, e);
        m[r] = m_new;
      }
    }
  }

  // merge the groups of each warp: lanes o apart (o a multiple of G) hold
  // the same head-dim slice of different groups
#pragma unroll
  for (int o = G; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float m_new = fmaxf(m[r], m_o);
      const float a = expf(m[r] - m_new), c = expf(m_o - m_new);
      l[r] = a * l[r] + c * l_o;
#pragma unroll
      for (int e = 0; e < CODES; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = a * acc[r][e] + c * acc_o;
      }
      m[r] = m_new;
    }
  }
  if (lane < G) {
#pragma unroll
    for (int r = 0; r < DEC_ROWS; ++r) {
      if (lane == 0) {
        m_s[warp][r] = m[r];
        l_s[warp][r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < CODES; ++e) acc_s[warp][r][e0 + e] = acc[r][e];
    }
  }
  __syncthreads();
  for (int i = tid; i < DEC_ROWS * D; i += DEC_THREADS) {
    const int r = i / D, d = i % D;
    if (r0 + r >= Tq) continue;
    float mx = NEG_INF;
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, m_s[w][r]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float wt = expf(m_s[w][r] - mx);
      lsum += wt * l_s[w][r];
      o += wt * acc_s[w][r][d];
    }
    const float safe_l = lsum == 0.f ? 1.f : lsum;  // safe divide, as :364
    out[qo + (r0 + r) * row_stride + d] = from_float<T>(o / safe_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const int* tables, const int* lengths, void* out,
           int B, int Tq, int H, int NB, int BS, int MB, float scale,
           cudaStream_t stream) {
  const dim3 grid(H, B, (Tq + DEC_ROWS - 1) / DEC_ROWS);
  decode_paged_int8_kernel<T, D><<<grid, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const int8_t*>(kp),
      static_cast<const int8_t*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), tables, lengths, static_cast<T*>(out),
      Tq, H, NB, BS, MB, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* kp, const void* vp, const void* ks,
               const void* vs, const int* tables, const int* lengths,
               void* out, int B, int Tq, int H, int D, int NB, int BS, int MB,
               float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kp, vp, ks, vs, tables, lengths, out, B, Tq, H, NB, BS, MB, scale, s);
    case 32: return launch<T, 32>(q, kp, vp, ks, vs, tables, lengths, out, B, Tq, H, NB, BS, MB, scale, s);
    case 64: return launch<T, 64>(q, kp, vp, ks, vs, tables, lengths, out, B, Tq, H, NB, BS, MB, scale, s);
    case 128: return launch<T, 128>(q, kp, vp, ks, vs, tables, lengths, out, B, Tq, H, NB, BS, MB, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaGetLastError() code of the launch (0 = launched).
extern "C" int ds_decode_paged_int8(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lengths, void* out, int is_bf16, int B, int Tq, int H, int D,
    int NB, int BS, int MB, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale, t,
                                     ln, out, B, Tq, H, D, NB, BS, MB, scale,
                                     s);
  return dispatch_d<float>(q, k_pool, v_pool, k_scale, v_scale, t, ln, out, B,
                           Tq, H, D, NB, BS, MB, scale, s);
}
