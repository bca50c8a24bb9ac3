// Prefill chunks of paged attention over an int8 KV cache on Hopper's
// tensor cores (sm_90a): bf16 q, head dim 64.
//
// Replaces, for the chunks, the TPU kernel _paged_int8_kernel
// (deepspeed_tpu/ops/decode_attention.py:319, launched by
// decode_attention_paged_int8 at :425): T_q query rows of batch row b
// attend the keys at logical positions [0, lengths[b] + T_q) through the
// row's block table, row r seeing keys <= lengths[b] + r, over int8 code
// pools [NB, BS, H, 64] with one fp32 scale per (token, head) in
// [NB, BS, H, 1] side pools. The wrapper (ops/decode_attention.py:
// int8_source) sends a call here by a rule on the shapes alone: bf16 q,
// D = 64, T_q >= TC_MIN_ROWS and a block size of at least 2 that divides
// 64 or is a multiple of it; every other call runs decode_paged_int8.cu.
//
// Rounding: S = Q . codes^T on wgmma in fp32 (the codes converted to bf16
// exactly: |code| <= 127 fits bf16's 8 significant bits), times
// k_scale * scale per key; an fp32 online softmax whose sum l takes the
// unrounded p; P' = p * v_scale in fp32, rounded to bf16, and O += P' .
// V_codes on wgmma with an fp32 accumulator; a safe divide when l == 0.
// The bf16 P' is a deliberate difference: the TPU kernel keeps p and V in
// fp32 (:355-357); it is the rounding that the bf16 paged kernel does
// already (p.astype(v.dtype), :226-227).
//
// What bounds it on the H100: bytes. At the timed chunk of 256 rows at
// length 512 (B=1 H=12) it reads 0.77 MB of codes and scales and does 0.3
// GFLOP of bf16 products, 0.0006 ms either way. What held the CUDA-core
// kernel back there (0.1023 ms) was that each CTA of 4 query rows re-read
// every visible key: 64 CTAs a head paid the K/V bytes 64 times, and none
// of the work reached the tensor cores. Design, one CTA per (64 query rows,
// head, batch row), the CTAs of the last rows (most keys) first:
// - the CTA copies its row's table entries into shared memory; a producer
//   warp loads the Q rows by TMA (128-byte swizzle) and then, for each
//   64-key tile, into a ring of STAGES stages: the K and V codes of the
//   tile's pool blocks by TMA straight through the table (the pool is a
//   [NB, BS, H, D] array like a [B, T, H, D] one, so a box of min(BS, 64)
//   rows at (0, slot, h, table entry) gathers one block's rows, 64 / BS
//   loads a tile), and the tile's scales by cp.async (4 bytes at a stride
//   of H * 4, below TMA's 16-byte box row), both completing on the stage's
//   mbarrier, so no producer lane waits on a load. A table entry <= 0 (the
//   garbage sink) or >= NB, or a block past the CTA's last visible key, is
//   never loaded, and its keys' scales are zeros;
// - NCW consumer warpgroups take turns at the tiles of the same 64 rows
//   (one warpgroup alone left each scheduler one warp, which waited out
//   every latency: ~2.5 us a tile), each with panels of its own, and merge
//   their (acc, m, l) through shared memory at the end. Each converts its
//   tiles' codes to bf16 into the 128-byte-swizzled panels that wgmma's
//   descriptors read (the rows of unloaded blocks as zeros) and copies
//   the scales out of the stage before releasing it. The scale of a key
//   no row may see is 0 and its logit a select to -inf, so a NaN scale of
//   the garbage block never reaches the tensor cores;
// - S on wgmma (Q and K both K-major), the softmax in the accumulator's
//   fragments (exp2 of pre-scaled logits; masks as selects on the tiles
//   that the last visible key, the causal diagonal or an unloaded block
//   crosses), P' packed to bf16 in registers (the accumulator layout is
//   wgmma's A fragment) and O += P' . V with V MN-major from shared memory.
//   Each tile's wgmma are issued and retired in one uniform block.

#include <cmath>
#include <cstdint>

#include "attention_common.cuh"
#include "sm90_common.cuh"

using namespace dsport;
using namespace dsport::sm90;

namespace {

constexpr int D = 64;
constexpr int BK = 64;      // keys a tile
constexpr int STAGES = 6;   // tiles of codes and scales in flight
constexpr int NCW = 2;      // consumer warpgroups, taking turns at tiles
constexpr int THREADS = NCW * 128 + 32;  // and one producer warp
constexpr int ROWB = 2 * D;       // bytes of a bf16 panel row: the swizzle
constexpr int PANEL = 64 * ROWB;  // a 64-row bf16 tile (Q, K or V)
constexpr int CODES = BK * D;     // a tile of int8 codes
constexpr int Q_OFF = 0;
constexpr int PANEL_OFF = PANEL;  // warpgroup w's K at + 2 w PANEL, V after
constexpr int CODE_OFF = PANEL_OFF + NCW * 2 * PANEL;  // stage s: K at
                                                       // + 2 s CODES, V after
// the stages' scales (K's, then V's), then each warpgroup's tile in use
// (K's times the softmax scale in log2 units)
constexpr int SCALE_OFF = CODE_OFF + STAGES * 2 * CODES;
constexpr int MERGE = D / 2 + 4;  // a thread's acc, m and l, handed over
constexpr int MERGE_OFF = SCALE_OFF + (STAGES + NCW) * 2 * BK * 4;
constexpr int BAR_OFF = MERGE_OFF + (NCW - 1) * 128 * MERGE * 4;
constexpr int TBL_OFF = BAR_OFF + 8 * (1 + 2 * STAGES);
constexpr float LOG2E = 1.4426950408889634f;
// pool block 0 is the garbage sink (ops/decode_attention.py:GARBAGE_BLOCK)
constexpr int GARBAGE_BLOCK = 0;

// code e of 16 as an exact float: its byte, offset by 128 (xor 0x80),
// becomes the low byte of the float 2^23 + (code + 128), from which
// 2^23 + 128 is subtracted; a byte permute and an add instead of I2F,
// whose quarter rate bounded the conversion
__device__ __forceinline__ float code_at(const uint4& raw, int e) {
  const uint32_t word = (&raw.x)[e / 4] ^ 0x80808080u;
  const uint32_t bits = __byte_perm(word, 0x4B000000u, 0x7540 | (e % 4));
  return __uint_as_float(bits) - 8388736.f;
}

__global__ void __launch_bounds__(THREADS, 1)
decode_paged_int8_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ tables,
                              const int* __restrict__ lengths,
                              __nv_bfloat16* __restrict__ out, int Tq, int H,
                              int NB, int BS, int MB, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - smem_u32(smem_raw));
  float* const stage_sc = reinterpret_cast<float*>(sm + SCALE_OFF);
  int* const tbl_s = reinterpret_cast<int*>(sm + TBL_OFF);
  const uint32_t bar_q = base + BAR_OFF;
  const uint32_t bar_full = bar_q + 8;
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64;
  const int len = lengths[b];
  // the keys the CTA's last row sees, [0, n_keys), in 64-key tiles
  const int n_keys = min(len + min(q0 + 64, Tq), MB * BS);
  const int n_tiles = (n_keys + BK - 1) / BK;
  const int boxt = BS < BK ? BS : BK;  // rows a load: a block or 64 of it
  const int subs = BK / boxt;          // loads a tile
  const int box_shift = __ffs(boxt) - 1;
  const int tid = threadIdx.x, lane = tid % 32;

  for (int i = tid; i < (n_keys + BS - 1) / BS; i += THREADS)
    tbl_s[i] = tables[static_cast<long long>(b) * MB + i];
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      // the TMA bytes' arrival and one a producer lane (its scales'
      // cp.async)
      mbar_init(bar_full + 8 * s, 1 + 32);
      mbar_init(bar_empty + 8 * s, 4);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // tile t's keys [64 t, 64 t + 64) lie in table entries e0 + (j - k0) /
  // boxt (e0 = k0 / BS) at slots slot0 + (j - k0) % boxt (slot0 = k0 % BS:
  // 0 where BS <= 64): one division a tile, none a key. The tile's loads
  // that read a real pool block, as a bit mask: each lane of the calling
  // warp tests one load
  auto loaded = [&](int k0, int e0) {
    bool real = false;
    if (lane < subs && k0 + lane * boxt < n_keys) {
      const int blk = tbl_s[e0 + lane];
      real = blk > GARBAGE_BLOCK && blk < NB;
    }
    return __ballot_sync(0xffffffffu, real);
  };

  if (tid >= NCW * 128) {
    // ---------------- producer warp: lane 0 issues every TMA load, and
    // each lane copies 4 of a tile's 128 scales into the stage
    if (lane == 0) {
      mbar_expect_tx(bar_q, PANEL);
      tma_load_4d(base + Q_OFF, &tm_q, bar_q, 0, q0, h, b);
    }
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      if (t >= STAGES) mbar_wait(bar_empty + 8 * s, (t / STAGES - 1) & 1);
      const int k0 = t * BK, e0 = k0 / BS, slot0 = k0 % BS;
      const uint32_t mask = loaded(k0, e0);
      if (lane == 0) {
        const uint32_t kb = base + CODE_OFF + s * 2 * CODES;
        mbar_expect_tx(bar_full + 8 * s, __popc(mask) * 2 * boxt * D);
        for (int i = 0; i < subs; ++i) {
          if (!((mask >> i) & 1)) continue;
          const int blk = tbl_s[e0 + i];
          tma_load_4d(kb + i * boxt * D, &tm_k, bar_full + 8 * s, 0, slot0,
                      h, blk);
          tma_load_4d(kb + CODES + i * boxt * D, &tm_v, bar_full + 8 * s, 0,
                      slot0, h, blk);
        }
      }
      // the scales by cp.async, so the lanes never wait on a load: each
      // lane's copies count as its arrival on the stage once they land.
      // A key past n_keys or on an unloaded block gets 0: selected, never
      // multiplied in
      const uint32_t sc = smem_u32(stage_sc + s * 2 * BK);
#pragma unroll
      for (int i = lane; i < BK; i += 32) {
        const int box = i >> box_shift;
        const bool real = ((mask >> box) & 1) && k0 + i < n_keys;
        const long long r =
            real ? (static_cast<long long>(tbl_s[e0 + box]) * BS + slot0 +
                    (i & (boxt - 1))) * H + h
                 : 0;
        cp_async_4(sc + 4 * i, k_scale + r, real);
        cp_async_4(sc + 4 * (BK + i), v_scale + r, real);
      }
      cp_async_mbar_arrive(bar_full + 8 * s);
    }
    return;
  }

  // ---------------- consumers: warpgroup w takes tiles w, w + NCW, ... of
  // the same 64 query rows, in panels and scales of its own
  const int w = tid / 128, ct = tid % 128;
  const int warp = ct / 32, quad = lane % 4;
  const int row0 = q0 + 16 * warp + lane / 4;  // and row0 + 8
  const uint32_t kpanel = base + PANEL_OFF + w * 2 * PANEL;
  const uint32_t vpanel = kpanel + PANEL;
  uint8_t* const kpanel_g = sm + PANEL_OFF + w * 2 * PANEL;
  float* const ksc_s = stage_sc + (STAGES + w) * 2 * BK;
  float* const vsc_s = ksc_s + BK;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = w; t < n_tiles; t += NCW) {
    const int s = t % STAGES;
    const int k0 = t * BK;
    const uint32_t mask = loaded(k0, k0 / BS);
    mbar_wait(bar_full + 8 * s, (t / STAGES) & 1);
    // the warpgroup's last tile is done with its panels and scales
    named_barrier(1 + w, 128);
    {
      // codes to bf16: 512 16-byte rows of codes (K then V), 4 a thread;
      // row r's 16-byte chunk c lands at chunk c ^ (r % 8) of the 128-byte
      // swizzle
      const uint8_t* codes = sm + CODE_OFF + s * 2 * CODES;
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const int idx = ct + 128 * c4;
        const int kv = idx / 256, r = (idx % 256) / 4, c = idx % 4;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if ((mask >> (r >> box_shift)) & 1)
          raw = *reinterpret_cast<const uint4*>(codes + kv * CODES + r * D +
                                                16 * c);
        uint32_t wv[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          wv[e] = pack_bf16(code_at(raw, 2 * e), code_at(raw, 2 * e + 1));
        uint8_t* row = kpanel_g + kv * PANEL + r * ROWB;
        *reinterpret_cast<uint4*>(row + 16 * ((2 * c) ^ (r & 7))) =
            make_uint4(wv[0], wv[1], wv[2], wv[3]);
        *reinterpret_cast<uint4*>(row + 16 * ((2 * c + 1) ^ (r & 7))) =
            make_uint4(wv[4], wv[5], wv[6], wv[7]);
      }
      // the tile's scales out of the stage, which is released below; K's
      // times the softmax scale in log2 units
      const float sc = stage_sc[s * 2 * BK + ct];
      ksc_s[ct] = ct < BK ? sc * scale_log2 : sc;
    }
    fence_proxy_async();
    named_barrier(1 + w, 128);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // stage s is free
    if (t == w) mbar_wait(bar_q, 0);

    // S = Q . codes^T
    float sc[BK / 2];
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      WgmmaSS<BK>::run(sc, desc(base + Q_OFF + 32 * kk, ROWB),
                       desc(kpanel + 32 * kk, ROWB), kk != 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // logits in log2 units; keys no row of the tile may see -inf (only the
    // tiles that the causal diagonal, the last key or an unloaded block
    // crosses)
    const bool masked = k0 + BK - 1 > len + q0 || k0 + BK > n_keys ||
                        mask != (subs == 32 ? ~0u : (1u << subs) - 1);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int hh = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + 2 * quad + (i & 1);
      float x = sc[i] * ksc_s[c];
      if (masked) {
        const int col = k0 + c;
        if (col > len + row0 + 8 * hh || col >= n_keys ||
            !((mask >> (c >> box_shift)) & 1))
          x = -INFINITY;
      }
      sc[i] = x;
    }
    // each row's max over its 16 columns as a tree: row hh holds elements
    // 4 k + 2 hh and 4 k + 2 hh + 1
    float mx[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float t8[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        t8[k] = fmaxf(sc[4 * k + 2 * hh], sc[4 * k + 2 * hh + 1]);
#pragma unroll
      for (int k = 0; k < 4; ++k) t8[k] = fmaxf(t8[k], t8[k + 4]);
      mx[hh] = fmaxf(fmaxf(t8[0], t8[2]), fmaxf(t8[1], t8[3]));
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      // a row with no visible key yet keeps m = -inf: exp2 against 0
      // gives its masked keys p = 0 and alpha = 0, never NaN
      mu[hh] = m_new == -INFINITY ? 0.f : m_new;
      alpha[hh] = exp2f(m[hh] - mu[hh]);
      m[hh] = m_new;
    }
    // the row sums of the unrounded p, in pairs and then a tree (pair
    // i / 2 belongs to row (i / 2) % 2)
    float rp[BK / 4];
    uint32_t p[BK / 16][4];
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int hh = (i >> 1) & 1;
      const int c = 8 * (i >> 2) + 2 * quad;
      const float p0 = exp2f(sc[i] - mu[hh]), p1 = exp2f(sc[i + 1] - mu[hh]);
      rp[i / 2] = p0 + p1;
      // P' = p * v_scale, rounded to bf16: the accumulator's 16 columns of
      // slice kk are the A fragment of the P'.V wgmma for keys 16 kk ..
      p[i / 8][(i % 8) / 2] = pack_bf16(p0 * vsc_s[c], p1 * vsc_s[c + 1]);
    }
    float rs[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      rs[hh] = ((rp[hh] + rp[2 + hh]) + (rp[4 + hh] + rp[6 + hh])) +
               ((rp[8 + hh] + rp[10 + hh]) + (rp[12 + hh] + rp[14 + hh]));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // O += P' . V_codes
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(p[kk]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      WgmmaRS<D>::run(acc, p[kk], desc(vpanel + 16 * ROWB * kk, ROWB));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(p[kk]);
  }

  // the warpgroups' states merged: warpgroups 1 .. NCW - 1 hand their
  // (acc, m, l) over, thread by thread (the same rows and columns), to
  // warpgroup 0, which takes them in that order
  float* const merge = reinterpret_cast<float*>(sm + MERGE_OFF);
  if (w > 0) {
    float* const mg = merge + ((w - 1) * 128 + ct) * MERGE;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) mg[i] = acc[i];
    mg[D / 2] = m[0];
    mg[D / 2 + 1] = m[1];
    mg[D / 2 + 2] = l[0];
    mg[D / 2 + 3] = l[1];
  }
  named_barrier(1 + NCW, NCW * 128);
  if (w > 0) return;
  for (int v = 1; v < NCW; ++v) {
    const float* const mg = merge + ((v - 1) * 128 + ct) * MERGE;
    float a0[2], a1[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float m1 = mg[D / 2 + hh];
      const float m_new = fmaxf(m[hh], m1);
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      a0[hh] = exp2f(m[hh] - mu);
      a1[hh] = exp2f(m1 - mu);
      l[hh] = a0[hh] * l[hh] + a1[hh] * mg[D / 2 + 2 + hh];
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      const int hh = (i >> 1) & 1;
      acc[i] = a0[hh] * acc[i] + a1[hh] * mg[i];
    }
  }

  // epilogue: the row sums across the quad, O = acc / l
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = row0 + 8 * hh;
    if (row >= Tq) continue;
    const float safe_l = l[hh] == 0.f ? 1.f : l[hh];
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(b) * Tq + row) * H + h) * D;
#pragma unroll
    for (int jb = 0; jb < D / 8; ++jb)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jb + 2 * quad) =
          __floats2bfloat162_rn(__fdiv_rn(acc[4 * jb + 2 * hh], safe_l),
                                __fdiv_rn(acc[4 * jb + 2 * hh + 1], safe_l));
  }
}

}  // namespace

// bf16 q and out [B, T_q, H, 64] and int8 pools [NB, BS, H, 64], all
// contiguous and 16-byte aligned; fp32 scales [NB, BS, H, 1]; int32 tables
// [B, MB] and lengths [B]. Returns 0 when launched, a cudaError_t code
// (cudaErrorInvalidValue for a head dim other than 64, a block size below
// 2 that neither divides 64 nor is a multiple of it, or a grid past its
// limits), or 10000 + the CUresult of a tensor map that
// cuTensorMapEncodeTiled refused.
extern "C" int ds_decode_paged_int8_sm90(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* lengths, void* out, int B, int Tq, int H, int head_dim,
    int NB, int BS, int MB, float scale, void* stream) {
  if (head_dim != D || BS < 2 || (BK % BS != 0 && BS % BK != 0) || B < 1 ||
      B > 65535 || H > 65535 || Tq < 1 || MB < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row = static_cast<long long>(H) * D;  // a token's elements
  const int boxt = BS < BK ? BS : BK;
  CUtensorMap tm_q, tm_k, tm_v;
  int e = make_bthd_map(&tm_q, q, B, H, Tq, D, Tq * row, D, row, D, 64);
  if (!e)
    e = make_bthd_map(&tm_k, k_pool, NB, H, BS, D, BS * row, D, row, D, boxt,
                      CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, false);
  if (!e)
    e = make_bthd_map(&tm_v, v_pool, NB, H, BS, D, BS * row, D, row, D, boxt,
                      CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, false);
  if (e) return TENSOR_MAP_ERROR + e;
  const int smem = 1024 + TBL_OFF + MB * static_cast<int>(sizeof(int));
  static int granted = 0;  // the >48 KB opt-in, raised as tables grow
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_paged_int8_sm90_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  const dim3 grid((Tq + 63) / 64, H, B);
  decode_paged_int8_sm90_kernel<<<grid, THREADS, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale),
      static_cast<const int*>(block_tables),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), Tq,
      H, NB, BS, MB, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}
