// Flash attention backward, dK/dV pass, for Hopper (sm_90a) on the tensor
// cores, bf16.
//
// Replaces the TPU kernel _bwd_dkv_kernel (deepspeed_tpu/ops/flash_attention.py:252,
// launched by _flash_backward at :355) and, through the strides of the
// tensor maps, _bwd_dkv_kernel_bthd (:516, launched at :615) for bf16
// inputs; fp32 stays on flash_bwd_dkv.cu's CUDA-core kernel, since the
// tensor cores would round fp32 operands to TF32. The TPU kernel's rounding
// points are kept: p = exp(s * scale - lse) in fp32 from the forward's
// logsumexp, dV += bf16(p)^T . dO (p.astype(do.dtype)), ds = p * (dp -
// delta) * scale from the unrounded p with dp = dO . V^T, and dK +=
// bf16(ds)^T . Q (ds.astype(q.dtype)), both sums in fp32; delta =
// rowsum(dO * O) comes from the caller in fp32. Bottom-right causal mask
// (key j is seen by rows i with j <= i + Tk - Tq); rows that see no key
// (lse = NEG_INF) contribute nothing; a key that no row sees gets dK = dV
// = 0.
//
// What bounds it on the H100: operations. At GPT-2's training shape
// (B=16 H=12 T=1024 D=64, causal) it does 8 * D flops per visible (query,
// key) pair, 1.0e8 pairs -> 5.2e10 bf16 flops, 0.052 ms at 989 TF/s,
// against 153 MB of q, k, v, dO, dK, dV, lse and delta, 0.046 ms at 3.35
// TB/s. On the fp32 CUDA cores (67 TF/s) the same work needs 0.78 ms at
// least, so only wgmma comes near the bound. Design, one CTA per (64 * NWG
// key rows, batch x head), on the building blocks of sm90_common.cuh:
// - one producer warp loads the CTA's K and V rows once by TMA, then walks
//   the query tiles of BQ rows that can see the CTA's first key (from row
//   max(0, k0 - (Tk - Tq)) to Tq; tiles below are never loaded) through a
//   ring of STAGES stages: Q and dO by TMA on one mbarrier, and lse
//   (pre-scaled by log2 e) and delta by plain loads of its 32 lanes on
//   another (a 2-d tensor map over [B*H, Tq] fp32 would break TMA's 16-byte
//   stride rule whenever Tq is not a multiple of 4);
// - NWG consumer warpgroups own 64 key rows each and share every tile. The
//   kernel computes the transposed scores directly: S^T = K.Q^T and dP^T =
//   V.dO^T are wgmma.m64nBQk16 per 16-deep slice of the head dim, both
//   operands K-major from swizzled shared memory, with the warpgroup's keys
//   as the M side. The accumulators are then P^T and dS^T laid out by key
//   rows, which is already wgmma's A-fragment layout, so p and ds are
//   rounded to bf16 in registers and dV += P^T.dO, dK += dS^T.Q are wgmma
//   with A from registers and dO, Q read MN-major from the same stage (the
//   instruction transposes them): no transposed copy, no shared-memory
//   round trip. dP^T runs while p is computed, then the dV and dK
//   products run back to back; every wgmma of a tile is issued and
//   retired with no barrier wait or branch in between, and the masks are
//   selects;
// - a tile wholly above a warpgroup's causal start is not computed;
// - dK and dV stay in fp32 registers across the whole walk and are written
//   once, in bf16, through the output strides: no atomics, no second pass;
// - 128 keys a CTA (NWG = 2) where B * H * ceil(Tk / 128) fills the SMs
//   and D <= 64, else 64 (NWG = 1): with two consumer warpgroups ptxas
//   allocates at most 168 registers a thread (65536 over 384 threads;
//   setmaxnreg did not raise it for the consumers), which dK, dV, S^T and
//   dP^T (then the bf16 P and dS) fit at D <= 64; the CTAs of the lowest
//   keys, which see the most query tiles, start first.
// Head dims 16, 32, 64 (one panel of 32-, 64- or 128-byte rows, BQ = 64)
// and 128 (two 64-wide panels, BQ = 32, so that dK, dV, S^T and dP^T fit
// the registers); any T; q, k, v, dO through tensor maps over their
// strides (the wrapper checks TMA's 16-byte rule), dK and dV through
// theirs; lse and delta contiguous [B, H, Tq] fp32.

#include <cmath>
#include <cstdint>

#include "attention_common.cuh"
#include "sm90_common.cuh"

using namespace dsport;
using namespace dsport::sm90;

namespace {

constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

template <int D, int NWG>
struct Cfg {
  static constexpr int PW = D < 64 ? D : 64;  // panel width (elements)
  static constexpr int NP = D / PW;           // panels of the head dim
  static constexpr int ROWB = 2 * PW;         // bytes a panel row = swizzle
  static constexpr int BQ = D == 128 ? 32 : 64;  // queries a tile
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int KV_PANEL = 64 * ROWB;  // one warpgroup's key rows
  static constexpr int KV_BYTES = NWG * NP * KV_PANEL;  // the CTA's K or V
  static constexpr int Q_PANEL = BQ * ROWB;
  static constexpr int Q_BYTES = NP * Q_PANEL;  // one Q or dO tile
  // a stage: Q, dO, then lse and delta (BQ floats each), padded to keep
  // the next stage on the 128-byte swizzle's 1024-byte atom
  static constexpr int STAT_OFF = 2 * Q_BYTES;
  static constexpr int STAGE_BYTES = 2 * Q_BYTES + 1024;
  static constexpr int RING_OFF = 2 * KV_BYTES;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's atom
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
};

template <int D, int NWG>
__global__ void __launch_bounds__(Cfg<D, NWG>::THREADS, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int H, int Tq,
                          int Tk, long long dk_sb, long long dk_sh,
                          long long dk_st, long long dv_sb, long long dv_sh,
                          long long dv_st, float scale, int causal) {
  using C = Cfg<D, NWG>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);  // generic view of base
  const uint32_t bar_kv = base + C::BAR_OFF;
  const uint32_t bar_full = bar_kv + 8;  // Q and dO by TMA
  const uint32_t bar_full_st = bar_full + 8 * STAGES;  // lse and delta
  const uint32_t bar_empty = bar_full_st + 8 * STAGES;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * 64 * NWG;
  const int off = Tk - Tq;  // bottom-right causal alignment
  // the first query row that sees the CTA's first key
  const int q_begin = causal ? max(0, k0 - off) : 0;
  const int n_tiles = q_begin < Tq ? (Tq - q_begin + BQ - 1) / BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_full_st + 8 * s, 32);     // the producer warp's lanes
      mbar_init(bar_empty + 8 * s, 4 * NWG);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, read from lane 0 so that the compiler knows it is
  // warp-uniform (as CUTLASS's canonical_warp_group_idx): the role branches
  // and the branches around wgmma are then not divergent
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {
    // ---------------- producer: warp 0 of the last warpgroup
    const int lane = threadIdx.x - NWG * 128;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
        for (int w = 0; w < NWG; ++w)
          for (int pn = 0; pn < C::NP; ++pn) {
            const uint32_t at = (w * C::NP + pn) * C::KV_PANEL;
            tma_load_4d(base + at, &tm_k, bar_kv, pn * C::PW, k0 + 64 * w,
                        h, b);
            tma_load_4d(base + C::KV_BYTES + at, &tm_v, bar_kv, pn * C::PW,
                        k0 + 64 * w, h, b);
          }
      }
      const float* lse_bh = lse + static_cast<long long>(bh) * Tq;
      const float* delta_bh = delta + static_cast<long long>(bh) * Tq;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int qt0 = q_begin + t * BQ;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, (t / STAGES - 1) & 1);
        const uint32_t sb = base + C::RING_OFF + s * C::STAGE_BYTES;
        if (lane == 0) {
          mbar_expect_tx(bar_full + 8 * s, 2 * C::Q_BYTES);
          for (int pn = 0; pn < C::NP; ++pn) {
            tma_load_4d(sb + pn * C::Q_PANEL, &tm_q, bar_full + 8 * s,
                        pn * C::PW, qt0, h, b);
            tma_load_4d(sb + C::Q_BYTES + pn * C::Q_PANEL, &tm_do,
                        bar_full + 8 * s, pn * C::PW, qt0, h, b);
          }
        }
        float* st = reinterpret_cast<float*>(sbase + (sb - base) +
                                             C::STAT_OFF);
        for (int i = lane; i < BQ; i += 32) {
          const int q = qt0 + i;
          st[i] = q < Tq ? lse_bh[q] * LOG2E : 0.f;
          st[BQ + i] = q < Tq ? delta_bh[q] : 0.f;
        }
        mbar_arrive(bar_full_st + 8 * s);
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns 64 key rows
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    const int wk0 = k0 + 64 * wg;
    const int key0 = wk0 + 16 * warp + lane / 4;  // and key0 + 8
    // the first query row that sees this warpgroup's first key
    const int wq_begin = causal ? max(0, wk0 - off) : 0;
    const bool has_keys = wk0 < Tk;
    const uint32_t ka = base + wg * C::NP * C::KV_PANEL;
    const uint32_t va = ka + C::KV_BYTES;
    const float scale_log2 = scale * LOG2E;
    // key j is visible to query q <= Tq - 1 where j <= q + reach (every
    // key < Tk without the causal mask; keys past Tk are never written)
    const int reach = causal ? off : Tk;

    float acc_k[C::NP][C::PW / 2], acc_v[C::NP][C::PW / 2];
#pragma unroll
    for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
      for (int i = 0; i < C::PW / 2; ++i) acc_k[pn][i] = acc_v[pn][i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const int qt0 = q_begin + t * BQ;
      // a tile wholly above this warpgroup's causal start is not computed
      // (the warpgroup still takes part in the stage's hand-over)
      const bool active = has_keys && qt0 + BQ > wq_begin;
      const uint32_t qs = base + C::RING_OFF + s * C::STAGE_BYTES;
      const uint32_t dos = qs + C::Q_BYTES;
      const float2* lse2 = reinterpret_cast<const float2*>(
          sbase + (qs - base) + C::STAT_OFF);
      const float2* delta2 = lse2 + BQ / 2;
      float sc[BQ / 2], dp[BQ / 2];
      uint32_t pk[BQ / 16][4], dsk[BQ / 16][4];

      mbar_wait(bar_full + 8 * s, parity);
      mbar_wait(bar_full_st + 8 * s, parity);
      // every wgmma of the tile is issued and retired inside this one
      // block, with no barrier wait or branch while one is in flight (a
      // wgmma outstanding across divergent code is serialized by ptxas)
      if (active) {
        // S^T = K . Q^T, then dP^T = V . dO^T, which runs while p is
        // computed
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
          for (int kk = 0; kk < C::PW / 16; ++kk)
            WgmmaSS<BQ>::run(sc, desc(ka + pn * C::KV_PANEL + 32 * kk, C::ROWB),
                             desc(qs + pn * C::Q_PANEL + 32 * kk, C::ROWB),
                             (pn | kk) != 0);
        wgmma_commit();
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
          for (int kk = 0; kk < C::PW / 16; ++kk)
            WgmmaSS<BQ>::run(dp, desc(va + pn * C::KV_PANEL + 32 * kk, C::ROWB),
                             desc(dos + pn * C::Q_PANEL + 32 * kk, C::ROWB),
                             (pn | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // S^T has landed
        fence_regs(sc);
        // p on the visible pairs (selects, no branch)
#pragma unroll
        for (int g = 0; g < BQ / 8; ++g) {
          const float2 l = lse2[4 * g + quad];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * g + e;
            const int q = qt0 + 8 * g + 2 * quad + (e & 1);
            const int key = key0 + 8 * (e >> 1);
            const float p = exp2f(sc[i] * scale_log2 - ((e & 1) ? l.y : l.x));
            sc[i] = q < Tq && key <= q + reach ? p : 0.f;
          }
        }
        wgmma_wait<0>();  // dP^T has landed
        fence_regs(dp);
        // ds = p * (dp - delta) * scale from the unrounded p
#pragma unroll
        for (int g = 0; g < BQ / 8; ++g) {
          const float2 dl = delta2[4 * g + quad];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * g + e;
            dp[i] = sc[i] * (dp[i] - ((e & 1) ? dl.y : dl.x)) * scale;
          }
        }
        // p and ds rounded to bf16: the 16 columns (queries) of slice kk
        // are the A fragments of dV += P^T . dO and dK += dS^T . Q for
        // queries 16 kk .. 16 kk + 15 (packing both before either product
        // frees the fp32 P^T and dS^T, which two warpgroups' 168
        // registers a thread could not hold beside dK, dV and the bf16
        // copies)
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 8 * kk + 2 * j;
            pk[kk][j] = pack_bf16(sc[i], sc[i + 1]);
            dsk[kk][j] = pack_bf16(dp[i], dp[i + 1]);
          }
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn) {
          fence_regs(acc_k[pn]);
          fence_regs(acc_v[pn]);
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          fence_regs(pk[kk]);
          fence_regs(dsk[kk]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int pn = 0; pn < C::NP; ++pn) {
            WgmmaRS<C::PW>::run(
                acc_v[pn], pk[kk],
                desc(dos + pn * C::Q_PANEL + 16 * C::ROWB * kk, C::ROWB));
            WgmmaRS<C::PW>::run(
                acc_k[pn], dsk[kk],
                desc(qs + pn * C::Q_PANEL + 16 * C::ROWB * kk, C::ROWB));
          }
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn) {
          fence_regs(acc_k[pn]);
          fence_regs(acc_v[pn]);
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          fence_regs(pk[kk]);
          fence_regs(dsk[kk]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // stage s is free
    }

    // epilogue: dK and dV of this thread's two key rows, in bf16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key0 + 8 * hh;
      if (key >= Tk) continue;
      __nv_bfloat16* krow = dk + b * dk_sb + h * dk_sh + key * dk_st;
      __nv_bfloat16* vrow = dv + b * dv_sb + h * dv_sh + key * dv_st;
#pragma unroll
      for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
        for (int jb = 0; jb < C::PW / 8; ++jb) {
          const int col = pn * C::PW + 8 * jb + 2 * quad;
          const int i = 4 * jb + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(krow + col) =
              __floats2bfloat162_rn(acc_k[pn][i], acc_k[pn][i + 1]);
          *reinterpret_cast<__nv_bfloat162*>(vrow + col) =
              __floats2bfloat162_rn(acc_v[pn][i], acc_v[pn][i + 1]);
        }
    }
  }
}

// st: (batch, head, token) element strides of q, k, v, dO (tensor maps),
// dK and dV
template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int B,
           int H, int Tq, int Tk, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  using C = Cfg<D, NWG>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int e = make_bthd_map(&tm_q, q, B, H, Tq, D, st[0], st[1], st[2], C::PW,
                        C::BQ);
  if (!e) e = make_bthd_map(&tm_k, k, B, H, Tk, D, st[3], st[4], st[5],
                            C::PW, 64);
  if (!e) e = make_bthd_map(&tm_v, v, B, H, Tk, D, st[6], st[7], st[8],
                            C::PW, 64);
  if (!e) e = make_bthd_map(&tm_do, dout, B, H, Tq, D, st[9], st[10],
                            st[11], C::PW, C::BQ);
  if (e) return TENSOR_MAP_ERROR + e;
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkv_sm90_kernel<D, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Tk + 64 * NWG - 1) / (64 * NWG), B * H);
  flash_bwd_dkv_sm90_kernel<D, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Tq, Tk, st[12], st[13], st[14],
      st[15], st[16], st[17], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int NWG>
int dispatch_d(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Tq, int Tk, int D, const long long* st,
               float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, NWG>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale, causal, s);
    case 32: return launch<32, NWG>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale, causal, s);
    case 64: return launch<64, NWG>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale, causal, s);
    // 64 keys a CTA at D = 128: dK and dV alone hold 128 fp32 registers a
    // thread, and two consumer warpgroups would spill
    case 128: return launch<128, 1>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16 q, k, v, dO, dK, dV as [B, H, T, D] views with element strides
// (batch, head, token) and a contiguous last dim; lse and delta contiguous
// fp32 [B, H, Tq]; Tq, Tk >= 1. Returns 0 when launched, a cudaError_t
// code, or 10000 + the CUresult of a tensor map that
// cuTensorMapEncodeTiled refused.
extern "C" int ds_flash_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Tq, int Tk, int D, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long do_sb, long long do_sh,
    long long do_st, long long dk_sb, long long dk_sh, long long dk_st,
    long long dv_sb, long long dv_sh, long long dv_st, float scale,
    int causal, void* stream) {
  const long long st[18] = {q_sb,  q_sh,  q_st,  k_sb,  k_sh,  k_st,
                            v_sb,  v_sh,  v_st,  do_sb, do_sh, do_st,
                            dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  // 128 keys a CTA where that fills the SMs, else 64
  const long long ctas_128 = static_cast<long long>(B) * H * ((Tk + 127) / 128);
  if (ctas_128 >= sm_count())
    return dispatch_d<2>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, D, st,
                         scale, causal, s);
  return dispatch_d<1>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, D, st,
                       scale, causal, s);
}
