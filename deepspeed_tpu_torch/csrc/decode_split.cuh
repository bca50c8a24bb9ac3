// The split decode shared by the CUDA-core decode kernels (decode_append.cu,
// decode_paged.cu, decode_paged_int8.cu): up to DEC_ROWS query rows of one
// (batch row, head) attend the keys at logical positions [first, n_keys),
// row r seeing keys first <= j <= base + r, the keys cut over several CTAs
// (flash-decoding) and merged inside the same launch. `first` is the
// row's first key: a left-padded append cache's pad length, 0 for every
// other source (a compile-time 0, so the paged kernels' code is as
// without it).
//
// Decode moves K/V bytes and does little arithmetic (4 D flops a key and
// row against 4 D bytes of bf16 K and V, 2 D + 8 of int8 codes and
// scales), so the bound is memory bandwidth, and what holds a kernel back
// is too few bytes in flight: one CTA per (head, batch row, DEC_ROWS query
// rows) is 24-96 CTAs on 132 SMs at the decode shapes, each walking its
// 1000 keys in 16-32 serial trips. Design:
// - the grid is (head, batch row, DEC_ROWS-row group x split): the host
//   sizes it for `splits` splits of the cache a row group
//   (ops/decode_attention.py:decode_splits: enough for two CTAs an SM, from
//   the shapes alone, never the lengths or the index), and each CTA cuts
//   the keys its group sees, [first, n_keys) with n_keys = min(base + last
//   row + 1, capacity) and n = n_keys - first, into `active` = min(splits,
//   n / min_split_keys) splits (at least 1; the wrapper passes its
//   MIN_SPLIT_KEYS, 256): split i reads [first + i n / active, first +
//   (i + 1) n / active), and the CTAs past `active` end at once, before
//   they take a ticket. `active` is a function of the row group's batch
//   row alone, so every CTA of the group, the merging one included,
//   computes the same value, while rows of one launch may differ. The merge below costs ~3 us (fence,
//   ticket, a second pass), more than splitting a few hundred keys saves,
//   so a short cache takes one CTA a row group and no merge;
// - each lane group of D / 8 lanes loads UNROLL keys' K and V rows (8
//   elements a lane: 16 bytes of bf16, 32 of fp32, 8 of int8 codes) before
//   it does their math, with the query rows in shared memory;
// - a key's address comes from its source (below): the append cache's row
//   j, or a paged pool's block from the row's block table, whose entries
//   for the split's keys the CTA copies into shared memory once, so a key's
//   address is one shared-memory read away instead of a dependent global
//   read. A key whose table entry is the garbage block (or outside the
//   pool) is never read and switches its update off;
// - the lane groups' (m, l, acc) merge through shared memory into the
//   split's partial, written in fp32 to a workspace (cached per device and
//   stream by the wrapper and shared by the three kernels);
// - the last active CTA of each (batch row, head, row group) to finish,
//   which it learns from a ticket counter (__threadfence, then
//   atomicAdd), merges the partials in split order, so results are bitwise
//   the same from run to run, writes O and resets the counter to 0. With
//   one active split the CTA writes O directly.
#pragma once

#include <cstdint>

#include "attention_common.cuh"

namespace dsport {

constexpr int DEC_THREADS = 256;
constexpr int DEC_ROWS = 4;  // query rows a CTA; grid.z covers T_q
constexpr int VEC = 8;       // bf16/fp32 head-dim elements a lane a key
constexpr int UNROLL = 4;    // keys a lane group loads before their math
// the most splits a row group (the merge's shared arrays); the wrapper's
// ops/decode_attention.py:MAX_SPLITS, and the launches refuse more
constexpr int MAX_SPLITS = 64;
// pool block 0 is the garbage sink (ops/decode_attention.py:GARBAGE_BLOCK)
constexpr int GARBAGE_BLOCK = 0;

// one lane's 8 elements of a key's head row, kept as loaded (bf16: one
// 16-byte vector, 4 registers) until their math, so UNROLL keys' K and V
// fit beside the rows' state in 128 registers
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

// ---------------------------------------------------------------------------
// key sources. Each one gives the split decode:
//   Raw   one lane's share of a key's K and V as loaded;
//   base(b), capacity()   row r sees keys <= base + r, of at most capacity;
//   first(b, n_keys)   the row's first key, in [0, n_keys];
//   begin(b, h, k_lo, k_hi, tbl)   per CTA, before the block's first sync;
//   row(j)   the (token, head) row of key j, or -1: never read;
//   load / zero / keys / values   a key's elements as fp32;
//   score(dot, raw, scale), weight(p, raw)   the TPU kernel's rounding
//         points: the logit from q . k, and what multiplies V in P.V.
// ---------------------------------------------------------------------------
template <typename T>
struct RawKV8 {
  Raw8<T> k, v;
};

// K and V in q's dtype (bf16 or fp32): the logit (q . k) * scale, and p
// rounded to V's dtype before P.V (the TPU kernels' p.astype(v.dtype))
template <typename T, int D>
struct PlainKV {
  using Raw = RawKV8<T>;
  const T* k;
  const T* v;
  __device__ __forceinline__ void load(Raw& r, long long row, int e0) const {
    r.k.load(k + row * D + e0);
    r.v.load(v + row * D + e0);
  }
  __device__ __forceinline__ void zero(Raw& r) const {
    r.k.zero();
    r.v.zero();
  }
  __device__ __forceinline__ void keys(const Raw& r, float* x) const {
    r.k.get(x);
  }
  __device__ __forceinline__ void values(const Raw& r, float* x) const {
    r.v.get(x);
  }
  __device__ __forceinline__ float score(float dot, const Raw&,
                                         float scale) const {
    return dot * scale;
  }
  __device__ __forceinline__ float weight(float p, const Raw&) const {
    return round_to<T>(p);
  }
};

// the [B, S, H, D] append cache (TPU kernel _kernel): row j of batch row b
// at (b S + j) H + h, valid in [first[b], index + T_q) (first: the rows'
// left-padded prefix lengths, or null for none)
template <typename T, int D>
struct AppendKeys : PlainKV<T, D> {
  const int* index;
  const int* first_key;
  int S, H;
  long long b_row;  // b S H + h, set by begin
  __device__ __forceinline__ int base(int) const { return *index; }
  __device__ __forceinline__ int capacity() const { return S; }
  __device__ __forceinline__ int first(int b, int n_keys) const {
    return first_key ? min(max(first_key[b], 0), n_keys) : 0;
  }
  __device__ __forceinline__ void begin(int b, int h, int, int, int*) {
    b_row = static_cast<long long>(b) * S * H + h;
  }
  __device__ __forceinline__ long long row(int j) const {
    return b_row + static_cast<long long>(j) * H;
  }
};

// the paged block table of one row: key j lives in pool block
// table[j / BS] at slot j % BS of the [NB, BS, H, D] pools; the CTA's
// split's entries in shared memory
struct PagedTable {
  const int* tables;
  const int* lengths;
  int H, NB, BS, MB;
  const int* tbl;  // shared: entries blk0 ..
  int blk0, h;
  __device__ __forceinline__ int base(int b) const { return lengths[b]; }
  __device__ __forceinline__ int capacity() const { return MB * BS; }
  __device__ __forceinline__ int first(int, int) const { return 0; }
  __device__ __forceinline__ void begin(int b, int h_, int k_lo, int k_hi,
                                        int* tbl_s) {
    blk0 = k_lo / BS;
    const int n = k_hi > k_lo ? (k_hi - 1) / BS - blk0 + 1 : 0;
    const int* t = tables + static_cast<long long>(b) * MB + blk0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) tbl_s[i] = t[i];
    tbl = tbl_s;
    h = h_;
  }
  __device__ __forceinline__ long long row(int j) const {
    const int blk = tbl[j / BS - blk0];
    if (blk <= GARBAGE_BLOCK || blk >= NB) return -1;
    return (static_cast<long long>(blk) * BS + j % BS) * H + h;
  }
};

inline void set_table(PagedTable& t, const int* tables, const int* lengths,
                      int H, int NB, int BS, int MB) {
  t.tables = tables;
  t.lengths = lengths;
  t.H = H;
  t.NB = NB;
  t.BS = BS;
  t.MB = MB;
  t.tbl = nullptr;
  t.blk0 = 0;
  t.h = 0;
}

// bf16/fp32 pools (TPU kernel _paged_kernel)
template <typename T, int D>
struct PagedKeys : PagedTable, PlainKV<T, D> {};

// int8 pools with fp32 [NB, BS, H, 1] scales (TPU kernel
// _paged_int8_kernel): 8 codes a lane (an 8-byte load) and one scale a key
// each for K and V; q . codes times K's scale, then the softmax scale; p
// times V's scale stays fp32. Eight codes a lane keep a lane's state at
// the bf16 kernels' size (4 x 8 accumulators), so two CTAs fit an SM: at
// 16 codes a lane the kernel took 204 registers, one CTA an SM, and a
// decode step of 8 slots ran in two waves
struct RawI8 {
  uint2 k, v;
  float ks, vs;
};

template <int D>
struct PagedInt8Keys : PagedTable {
  using Raw = RawI8;
  const int8_t* k;
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  __device__ __forceinline__ void load(Raw& r, long long row, int e0) const {
    r.k = *reinterpret_cast<const uint2*>(k + row * D + e0);
    r.v = *reinterpret_cast<const uint2*>(v + row * D + e0);
    r.ks = k_scale[row];
    r.vs = v_scale[row];
  }
  __device__ __forceinline__ void zero(Raw& r) const {
    r.k = r.v = make_uint2(0u, 0u);
    r.ks = r.vs = 0.f;
  }
  static __device__ __forceinline__ void codes(const uint2& raw, float* x) {
    const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) x[e] = static_cast<float>(c[e]);
  }
  __device__ __forceinline__ void keys(const Raw& r, float* x) const {
    codes(r.k, x);
  }
  __device__ __forceinline__ void values(const Raw& r, float* x) const {
    codes(r.v, x);
  }
  __device__ __forceinline__ float score(float dot, const Raw& r,
                                         float scale) const {
    return dot * r.ks * scale;
  }
  __device__ __forceinline__ float weight(float p, const Raw& r) const {
    return p * r.vs;  // p stays fp32: no rounding to a dtype
  }
};

// ---------------------------------------------------------------------------
// the split decode itself, the body of each decode kernel (grid (H, B,
// ceil(T_q / DEC_ROWS) x splits), DEC_THREADS threads). q and out are
// [B, T_q, H, D]; ws holds B H ceil(T_q / DEC_ROWS) splits partials of
// DEC_ROWS (D + 2) fp32 values, tickets one int32 a row group, 0 before
// and after the launch; tbl_s the dynamic shared memory of a paged source
// (at least as many ints as a split's keys span table entries)
// ---------------------------------------------------------------------------
template <typename T, int D, typename Src>
__device__ __forceinline__ void split_decode(
    const T* __restrict__ q, Src src, T* __restrict__ out,
    float* __restrict__ ws, int* __restrict__ tickets, int Tq, int H,
    int splits, int min_split_keys, float scale, int* tbl_s) {
  constexpr int G = D / VEC;                // lanes a key
  constexpr int GROUPS = DEC_THREADS / G;   // keys a step, per unrolled key
  constexpr int PART = DEC_ROWS * (D + 2);  // a split's (m, l, acc) rows
  using Raw = typename Src::Raw;
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
  const int base = src.base(b);
  // the keys the group's last row sees, [k0, n_keys), cut into `active`
  // splits of at least min_split_keys keys each (one where there are
  // fewer, down to a single key): the rest of the grid's splits have
  // nothing to read and end
  const int n_keys = min(base + r0 + rows, src.capacity());
  const int k0 = src.first(b, n_keys);
  const int n_vis = n_keys - k0;
  const int active = max(1, min(splits, n_vis / min_split_keys));
  if (sp >= active) return;
  const int k_lo = k0 + sp * n_vis / active;
  const int k_hi = k0 + (sp + 1) * n_vis / active;
  const long long row_stride = static_cast<long long>(H) * D;
  const long long qo = (static_cast<long long>(b) * Tq * H + h) * D;
  const long long slot = (static_cast<long long>(b) * H + h) * n_groups + grp;
  float* part = ws + (slot * splits + sp) * PART;
  const int tid = threadIdx.x;
  const int g = tid / G;
  const int e0 = (tid % G) * VEC;

  src.begin(b, h, k_lo, k_hi, tbl_s);
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
  // group shuffles below are never divergent; keys past the split or on
  // the garbage block only switch their update off
  for (int jb = k_lo; jb < k_hi; jb += GROUPS * UNROLL) {
    Raw raw[UNROLL];
    bool ok[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = jb + u * GROUPS + g;
      const long long kr = j < k_hi ? src.row(j) : -1;
      ok[u] = kr >= 0;
      if (ok[u])
        src.load(raw[u], kr, e0);
      else
        src.zero(raw[u]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = jb + u * GROUPS + g;
      float kv[VEC], vv[VEC];
      src.keys(raw[u], kv);
      src.values(raw[u], vv);
#pragma unroll
      for (int r = 0; r < DEC_ROWS; ++r) {
        if (r >= rows) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) dot += q_s[r][e0 + e] * kv[e];
#pragma unroll
        for (int o = G / 2; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (ok[u] && j <= base + r0 + r) {
          const float s = src.score(dot, raw[u], scale);
          const float m_new = fmaxf(m[r], s);
          const float alpha = expf(m[r] - m_new);
          const float p = expf(s - m_new);
          l[r] = alpha * l[r] + p;
          const float pv = src.weight(p, raw[u]);
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
      const float safe_l = lsum == 0.f ? 1.f : lsum;  // the safe divide
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
    l_out[tid] = lsum == 0.f ? 1.f : lsum;  // the safe divide
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

// the launch checks the three kernels share: splits in [1, MAX_SPLITS] and
// no more than the keys, min_split_keys >= 1, grid.z within 65535
inline bool split_args_ok(long long Tq, int splits, int keys,
                          int min_split_keys) {
  const long long groups = (Tq + DEC_ROWS - 1) / DEC_ROWS;
  return splits >= 1 && splits <= MAX_SPLITS && splits <= keys &&
         min_split_keys >= 1 && groups * splits <= 65535;
}

// raises `kernel`'s dynamic shared memory limit to `bytes` where it is
// below `granted` (the limit one kernel instance has been given; a launch
// gets 48 KB without asking). Returns the cudaError_t code (0 = ok)
template <typename K>
inline int grant_smem(K kernel, int bytes, int& granted) {
  if (bytes <= granted) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  granted = bytes;
  return 0;
}

}  // namespace dsport
