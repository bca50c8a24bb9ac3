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
// What bounds it on the H100: the bytes of K and V below idx + T_q (4 D
// bytes a key and head in bf16 against 4 D flops a key and row; see
// decode_common.cuh). At B=2 H=12 S=1024 idx=1000 T_q=1 that is 6.15 MB,
// 1.84 us at 3.35 TB/s. What held the first version back was too few bytes
// in flight: one CTA per (head, batch row, DEC_ROWS query rows) is 24 CTAs
// on 132 SMs, each thread with one 16-byte K and one V load in flight a
// step, ~192 KB on the card, which at ~0.7 us of DRAM latency carries ~0.3
// TB/s (23.4 us measured). Design:
// - the grid is (head, batch row, DEC_ROWS-row group x split): the host
//   sizes it for `splits` splits of the cache a row group
//   (ops/decode_attention.py:append_splits: enough for two CTAs an SM,
//   from the shapes alone, never idx), and each CTA cuts the keys its
//   group sees, [0, n_keys) with n_keys = min(idx + last row + 1, S), into
//   `active` = min(splits, n_keys / min_split_keys) splits (at least 1;
//   the wrapper passes its MIN_SPLIT_KEYS, 256): split i reads
//   [i n_keys / active, (i + 1) n_keys / active), at least min_split_keys
//   keys, and the CTAs past `active` end at once. The merge below costs
//   ~3 us (fence, ticket, a second pass), more than splitting a few
//   hundred keys saves, so a short cache (under 512 keys) takes one CTA a
//   row group and no merge, as the first version did, and a long one
//   spreads evenly over its splits;
// - each lane group of D / 8 lanes loads UNROLL keys' K and V rows, 16 or
//   32 bytes a lane each, before it does their math, so a thread has
//   2 UNROLL loads in flight (32 KB a CTA in bf16), and two CTAs fit an SM;
// - the lane groups' (m, l, acc) merge through shared memory into the
//   split's partial, written in fp32 to a workspace (cached per device
//   and stream by the wrapper);
// - the last active CTA of each (batch row, head, row group) to finish,
//   which it learns from a ticket counter (__threadfence, then
//   atomicAdd), merges the partials in split order with decode_block's
//   rescaling, so results are bitwise the same from run to run, writes O
//   and resets the counter to 0. One launch a call; with one active split
//   the CTA writes O directly.

#include "decode_common.cuh"

using namespace dsport;

namespace {

constexpr int UNROLL = 4;  // keys a lane group loads before their math
// the most splits a row group (the merge's shared arrays); the wrapper's
// ops/decode_attention.py:MAX_SPLITS, and ds_decode_append refuses more
constexpr int MAX_SPLITS = 64;

// one lane's 8 elements of a key's head row, kept as loaded (bf16: one
// 16-byte vector, 4 registers) until their math, so UNROLL keys' K and V
// fit beside the rows' state in 128 registers (the query rows wait in
// shared memory)
template <typename T>
struct Raw8;
template <>
struct Raw8<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void zero() { v = make_uint4(0, 0, 0, 0); }
  __device__ __forceinline__ void get(float* out) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() {
    a = b = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void get(float* out) const {
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
};

// bf16: two CTAs an SM (128 registers a thread); fp32's raw rows are twice
// as wide, so one
template <typename T, int D>
__global__ void __launch_bounds__(DEC_THREADS, sizeof(T) == 2 ? 2 : 1)
decode_append_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc, const int* __restrict__ index,
                     T* __restrict__ out, float* __restrict__ ws,
                     int* __restrict__ tickets, int Tq, int H, int S,
                     int splits, int min_split_keys, float scale) {
  constexpr int G = D / VEC;                // lanes a key
  constexpr int GROUPS = DEC_THREADS / G;   // keys a step, per unrolled key
  constexpr int PART = DEC_ROWS * (D + 2);  // a split's (m, l, acc) rows
  __shared__ float m_s[GROUPS][DEC_ROWS];
  __shared__ float l_s[GROUPS][DEC_ROWS];
  __shared__ float acc_s[GROUPS][DEC_ROWS][D];
  __shared__ float q_s[DEC_ROWS][D];
  __shared__ int last;
  // the merge's per-split max (then weight) and sum, and each row's sum
  __shared__ float w_s[DEC_ROWS][MAX_SPLITS];
  __shared__ float lp_s[DEC_ROWS][MAX_SPLITS];
  __shared__ float l_out[DEC_ROWS];

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_groups = gridDim.z / splits;
  const int grp = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int r0 = grp * DEC_ROWS;
  const int rows = min(DEC_ROWS, Tq - r0);
  const int idx = *index;
  // the keys the group's last row sees, [0, n_keys), cut into `active`
  // splits of at least min_split_keys keys each (one where there are
  // fewer): the rest of the grid's splits have nothing to read and end
  const int n_keys = min(idx + r0 + rows, S);
  const int active = max(1, min(splits, n_keys / min_split_keys));
  if (sp >= active) return;
  const int k_lo = sp * n_keys / active;
  const int k_hi = (sp + 1) * n_keys / active;
  const long long row_stride = static_cast<long long>(H) * D;
  const long long qo = (static_cast<long long>(b) * Tq * H + h) * D;
  const long long slot = (static_cast<long long>(b) * H + h) * n_groups + grp;
  float* part = ws + (slot * splits + sp) * PART;
  const int tid = threadIdx.x;
  const int g = tid / G;
  const int e0 = (tid % G) * VEC;

  // the group's query rows in fp32, read from shared memory at each use
  for (int i = tid; i < rows * D; i += DEC_THREADS)
    q_s[i / D][i % D] = to_float(q[qo + (r0 + i / D) * row_stride + i % D]);
  float m[DEC_ROWS], l[DEC_ROWS], acc[DEC_ROWS][VEC];
#pragma unroll
  for (int r = 0; r < DEC_ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[r][e] = 0.f;
  }
  __syncthreads();

  // every lane runs the same trip count, and `rows` is the CTA's, so the
  // group shuffles below are never divergent; keys past the split only
  // switch their update off
  for (int jb = k_lo; jb < k_hi; jb += GROUPS * UNROLL) {
    Raw8<T> kraw[UNROLL], vraw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = jb + u * GROUPS + g;
      if (j < k_hi) {
        const long long kr =
            ((static_cast<long long>(b) * S + j) * H + h) * D + e0;
        kraw[u].load(kc + kr);
        vraw[u].load(vc + kr);
      } else {
        kraw[u].zero();
        vraw[u].zero();
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = jb + u * GROUPS + g;
      float kv[VEC], vv[VEC];
      kraw[u].get(kv);
      vraw[u].get(vv);
#pragma unroll
      for (int r = 0; r < DEC_ROWS; ++r) {
        if (r >= rows) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += q_s[r][e0 + e] * kv[e];
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (j < k_hi && j <= idx + r0 + r) {
          const float s = dot * scale;
          const float m_new = fmaxf(m[r], s);
          const float alpha = expf(m[r] - m_new);
          const float p = expf(s - m_new);
          l[r] = alpha * l[r] + p;
          const float pv = round_to<T>(p);  // p.astype(v.dtype)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[r][e] = alpha * acc[r][e] + pv * vv[e];
          m[r] = m_new;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < DEC_ROWS; ++r) {
    if (r >= rows) break;
    if (e0 == 0) {
      m_s[g][r] = m[r];
      l_s[g][r] = l[r];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc_s[g][r][e0 + e] = acc[r][e];
  }
  __syncthreads();
  // the lane groups' states merged: O itself where one split holds every
  // visible key, else the split's partial, relative to its own max
  for (int i = tid; i < rows * D; i += DEC_THREADS) {
    const int r = i / D, d = i % D;
    float mx = NEG_INF;
    for (int gg = 0; gg < GROUPS; ++gg) mx = fmaxf(mx, m_s[gg][r]);
    float lsum = 0.f, o = 0.f;
    for (int gg = 0; gg < GROUPS; ++gg) {
      const float w = expf(m_s[gg][r] - mx);
      lsum += w * l_s[gg][r];
      o += w * acc_s[gg][r][d];
    }
    if (active == 1) {
      const float safe_l = lsum == 0.f ? 1.f : lsum;  // safe divide, as :79
      out[qo + (r0 + r) * row_stride + d] = from_float<T>(o / safe_l);
    } else {
      float* pr = part + r * (D + 2);
      if (d == 0) {
        pr[0] = mx;
        pr[1] = lsum;
      }
      pr[2 + d] = o;
    }
  }
  if (active == 1) return;

  // the ticket: every thread's partial is visible device-wide before the
  // CTA counts itself done; the CTA that counts last merges
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + slot, 1) == active - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the merge, in split order. The partials are read past L1 (__ldcg:
  // other CTAs wrote them), each split's m and l by a thread of its own,
  // so the reads overlap instead of queueing one behind another; a row
  // with no visible key in a split (l == 0) takes nothing from it
  const float* parts = ws + slot * splits * PART;
  for (int i = tid; i < rows * active; i += DEC_THREADS) {
    const int r = i / active, s = i % active;
    const float* pr = parts + s * PART + r * (D + 2);
    w_s[r][s] = __ldcg(pr);
    lp_s[r][s] = __ldcg(pr + 1);
  }
  __syncthreads();
  if (tid < rows) {
    float mx = NEG_INF;
    for (int s = 0; s < active; ++s)
      if (lp_s[tid][s] > 0.f) mx = fmaxf(mx, w_s[tid][s]);
    float lsum = 0.f;
    for (int s = 0; s < active; ++s) {
      const float w = lp_s[tid][s] > 0.f ? expf(w_s[tid][s] - mx) : 0.f;
      w_s[tid][s] = w;  // the split's weight from here on
      lsum += w * lp_s[tid][s];
    }
    l_out[tid] = lsum == 0.f ? 1.f : lsum;  // safe divide, as :79
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += DEC_THREADS) {
    const int r = i / D, d = i % D;
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < active; ++s)
      if (lp_s[r][s] > 0.f) o += w_s[r][s] * __ldcg(parts + s * PART +
                                                    r * (D + 2) + 2 + d);
    out[qo + (r0 + r) * row_stride + d] = from_float<T>(o / l_out[r]);
  }
  if (tid == 0) tickets[slot] = 0;  // ready for the next launch
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const int* index,
           void* out, float* ws, int* tickets, int B, int Tq, int H, int S,
           int splits, int min_keys, float scale, cudaStream_t stream) {
  const int groups = (Tq + DEC_ROWS - 1) / DEC_ROWS;
  const dim3 grid(H, B, groups * splits);
  decode_append_kernel<T, D><<<grid, DEC_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), index, static_cast<T*>(out), ws, tickets,
      Tq, H, S, splits, min_keys, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* kc, const void* vc,
               const int* index, void* out, float* ws, int* tickets, int B,
               int Tq, int H, int D, int S, int splits, int min_keys,
               float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, kc, vc, index, out, ws, tickets, B, Tq, H, S, splits, min_keys, scale, s);
    case 32: return launch<T, 32>(q, kc, vc, index, out, ws, tickets, B, Tq, H, S, splits, min_keys, scale, s);
    case 64: return launch<T, 64>(q, kc, vc, index, out, ws, tickets, B, Tq, H, S, splits, min_keys, scale, s);
    case 128: return launch<T, 128>(q, kc, vc, index, out, ws, tickets, B, Tq, H, S, splits, min_keys, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// workspace: fp32, B * H * ceil(T_q / 4) * splits * 4 * (D + 2) values (a
// split's partial per row: m, l, acc); tickets: int32, B * H * ceil(T_q /
// 4) counters, 0 before the launch and 0 again after it. A row group cuts
// its visible keys into at most `splits` splits of at least
// `min_split_keys` keys (ops/decode_attention.py:MIN_SPLIT_KEYS). Returns
// the cudaGetLastError() code of the launch (0 = launched), or
// cudaErrorInvalidValue for splits outside [1, min(S, 64)], min_split_keys
// below 1 or a grid past 65535 in z.
extern "C" int ds_decode_append(const void* q, const void* k_cache,
                                const void* v_cache, const void* cache_index,
                                void* out, void* workspace, void* tickets,
                                int is_bf16, int B, int Tq, int H, int D,
                                int S, int splits, int min_split_keys,
                                float scale, void* stream) {
  const long long groups = (Tq + DEC_ROWS - 1) / DEC_ROWS;
  if (splits < 1 || splits > MAX_SPLITS || splits > S ||
      min_split_keys < 1 || groups * splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(cache_index);
  float* w = static_cast<float*>(workspace);
  int* t = static_cast<int*>(tickets);
  if (is_bf16)
    return dispatch_d<__nv_bfloat16>(q, k_cache, v_cache, idx, out, w, t, B,
                                     Tq, H, D, S, splits, min_split_keys,
                                     scale, s);
  return dispatch_d<float>(q, k_cache, v_cache, idx, out, w, t, B, Tq, H, D,
                           S, splits, min_split_keys, scale, s);
}
