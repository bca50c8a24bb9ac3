// Flash attention backward, dQ pass, for Hopper (sm_90a) on the tensor
// cores, bf16.
//
// Replaces the TPU kernel _bwd_dq_kernel (deepspeed_tpu/ops/flash_attention.py:196,
// launched by _flash_backward at :336) and, through the strides of the
// tensor maps, _bwd_dq_kernel_bthd (:509, launched at :591) for bf16
// inputs; fp32 stays on flash_bwd_dq.cu's CUDA-core kernel, since the
// tensor cores would round fp32 operands to TF32. The TPU kernel's rounding
// points are kept: p = exp(s * scale - lse) in fp32 from the forward's
// logsumexp, ds = p * (dp - delta) * scale with dp = dO . V^T, rounded to
// bf16 (ds.astype(k.dtype)), and dQ += ds . K summed in fp32 and written
// once in bf16; delta = rowsum(dO * O) comes from the caller in fp32.
// Bottom-right causal mask (row i sees keys <= i + Tk - Tq); rows that see
// no key (lse = NEG_INF) get dQ = 0.
//
// What bounds it on the H100: operations. At GPT-2's training shape
// (B=16 H=12 T=1024 D=64, causal) it does 6 * D flops per visible (query,
// key) pair, 1.0e8 pairs -> 3.9e10 bf16 flops, 0.039 ms at 989 TF/s,
// against 127 MB of q, k, v, dO, dQ, lse and delta, 0.038 ms at 3.35 TB/s;
// on the fp32 CUDA cores (67 TF/s) it needs 0.58 ms at least. Design: the
// forward's (flash_fwd_sm90.cu), one CTA per (64 * NWG query rows, batch x
// head), on the building blocks of sm90_common.cuh:
// - one producer warp loads the CTA's Q and dO rows once by TMA, then K
//   and V tiles of BK = 64 keys into a ring of STAGES stages (one mbarrier
//   signals a full stage, another its release by the consumers), up to
//   the causal limit of the CTA's last row; rows past T read as zeros;
// - NWG consumer warpgroups own 64 query rows each and read their rows' lse
//   and delta once. On each tile S = Q.K^T and dP = dO.V^T are
//   wgmma.m64n64k16 per 16-deep slice of the head dim (K-major operands
//   from swizzled shared memory; dP runs while p is computed), p and ds
//   are computed on the fp32 accumulator fragments (masks by selects: no
//   wgmma is in flight across a branch or a barrier wait), ds is rounded
//   to bf16 in
//   registers, where the accumulator layout is already wgmma's A-fragment
//   layout, and dQ += dS.K is wgmma with A from registers and K read
//   MN-major from the stage (the instruction transposes it);
// - dQ stays in fp32 registers across the whole walk and is written once,
//   in bf16, through its strides: no atomics, no second pass. S and dP are
//   recomputed here and in the dK/dV kernel (7 products against a fused
//   kernel's 5), as the TPU kernels do, so both outputs stay deterministic;
// - 128 query rows a CTA (NWG = 2) where B * H * ceil(Tq / 128) fills the
//   SMs, else 64 (NWG = 1): with two consumer warpgroups ptxas allocates
//   at most 168 registers a thread (65536 over 384 threads; setmaxnreg
//   did not raise it for the consumers), which dQ, S, dP and the bf16 dS
//   of 64 keys fit; the CTAs of the longest causal rows start first.
// Head dims 16, 32, 64 (one panel of 32-, 64- or 128-byte rows) and 128
// (two 64-wide panels); any T; q, k, v, dO through tensor
// maps over their strides (the wrapper checks TMA's 16-byte rule), dQ
// through its own; lse and delta contiguous [B, H, Tq] fp32.

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
  static constexpr int BK = 64;  // keys a tile
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int Q_PANEL = 64 * ROWB;   // one warpgroup's rows
  static constexpr int Q_BYTES = NWG * NP * Q_PANEL;  // Q or dO of the CTA
  static constexpr int KV_PANEL = BK * ROWB;
  static constexpr int KV_BYTES = NP * KV_PANEL;  // one K or V tile
  static constexpr int RING_OFF = 2 * Q_BYTES;
  static constexpr int BAR_OFF = RING_OFF + STAGES * 2 * KV_BYTES;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's atom
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

template <int D, int NWG>
__global__ void __launch_bounds__(Cfg<D, NWG>::THREADS, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int H, int Tq,
                         int Tk, long long dq_sb, long long dq_sh,
                         long long dq_st, float scale, int causal) {
  using C = Cfg<D, NWG>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + C::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;  // a K and V tile
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64 * NWG;
  const int off = Tk - Tq;  // bottom-right causal alignment
  // keys the CTA's last row can see: the causal limit of the loads
  const int q_last = min(q0 + 64 * NWG, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + off + 1) : Tk;
  const int n_tiles = k_end > 0 ? (k_end + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
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
    // ---------------- producer: one thread issues every TMA load
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int pn = 0; pn < C::NP; ++pn) {
          const uint32_t at = (w * C::NP + pn) * C::Q_PANEL;
          tma_load_4d(base + at, &tm_q, bar_q, pn * C::PW, q0 + 64 * w, h, b);
          tma_load_4d(base + C::Q_BYTES + at, &tm_do, bar_q, pn * C::PW,
                      q0 + 64 * w, h, b);
        }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, (t / STAGES - 1) & 1);
        const uint32_t kb = base + C::RING_OFF + s * 2 * C::KV_BYTES;
        mbar_expect_tx(bar_full + 8 * s, 2 * C::KV_BYTES);
        for (int pn = 0; pn < C::NP; ++pn) {
          tma_load_4d(kb + pn * C::KV_PANEL, &tm_k, bar_full + 8 * s,
                      pn * C::PW, t * BK, h, b);
          tma_load_4d(kb + C::KV_BYTES + pn * C::KV_PANEL, &tm_v,
                      bar_full + 8 * s, pn * C::PW, t * BK, h, b);
        }
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns 64 query rows
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    const int wq0 = q0 + 64 * wg;
    const int row0 = wq0 + 16 * warp + lane / 4;  // and row0 + 8
    const int wq_last = min(wq0 + 63, Tq - 1);
    const int k_end_wg = wq0 >= Tq ? 0
                         : causal  ? min(Tk, wq_last + off + 1)
                                   : Tk;
    const uint32_t qa = base + wg * C::NP * C::Q_PANEL;
    const uint32_t doa = qa + C::Q_BYTES;
    const float scale_log2 = scale * LOG2E;
    // row i sees key j < Tk where j <= i + reach (every key without the
    // causal mask)
    const int reach = causal ? off : Tk;
    // this thread's two rows' lse (log2 units) and delta
    float lse2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      const long long at = static_cast<long long>(bh) * Tq + row;
      lse2[hh] = row < Tq ? lse[at] * LOG2E : 0.f;
      dl[hh] = row < Tq ? delta[at] : 0.f;
    }

    float acc[C::NP][C::PW / 2];
#pragma unroll
    for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
      for (int i = 0; i < C::PW / 2; ++i) acc[pn][i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const int k0 = t * BK;
      // a tile wholly above this warpgroup's causal limit is not computed
      // (the warpgroup still takes part in the stage's hand-over)
      const bool active = k0 < k_end_wg;
      const uint32_t kb = base + C::RING_OFF + s * 2 * C::KV_BYTES;
      const uint32_t vb = kb + C::KV_BYTES;
      float sc[BK / 2], dp[BK / 2];
      uint32_t dsk[BK / 16][4];

      mbar_wait(bar_full + 8 * s, parity);
      // every wgmma of the tile is issued and retired inside this one
      // block, with no barrier wait or branch while one is in flight (a
      // wgmma outstanding across divergent code is serialized by ptxas)
      if (active) {
        // S = Q . K^T, then dP = dO . V^T, which runs while p is computed
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
          for (int kk = 0; kk < C::PW / 16; ++kk)
            WgmmaSS<BK>::run(sc, desc(qa + pn * C::Q_PANEL + 32 * kk, C::ROWB),
                             desc(kb + pn * C::KV_PANEL + 32 * kk, C::ROWB),
                             (pn | kk) != 0);
        wgmma_commit();
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
          for (int kk = 0; kk < C::PW / 16; ++kk)
            WgmmaSS<BK>::run(dp, desc(doa + pn * C::Q_PANEL + 32 * kk, C::ROWB),
                             desc(vb + pn * C::KV_PANEL + 32 * kk, C::ROWB),
                             (pn | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // S has landed
        fence_regs(sc);
        // p on the visible pairs (selects, no branch)
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int hh = (i >> 1) & 1;
          const int col = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
          const float p = exp2f(sc[i] * scale_log2 - lse2[hh]);
          sc[i] = col < Tk && col <= row0 + 8 * hh + reach ? p : 0.f;
        }
        wgmma_wait<0>();  // dP has landed
        fence_regs(dp);
        // ds = p * (dp - delta) * scale rounded to bf16: the accumulator's
        // 16 columns of slice kk are the A fragment of dQ += dS . K for
        // keys 16 kk .. 16 kk + 15
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i = 8 * kk + 2 * j;
            const float d = dl[j & 1];
            dsk[kk][j] = pack_bf16(sc[i] * (dp[i] - d) * scale,
                                   sc[i + 1] * (dp[i + 1] - d) * scale);
          }
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn) fence_regs(acc[pn]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(dsk[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
          for (int pn = 0; pn < C::NP; ++pn)
            WgmmaRS<C::PW>::run(
                acc[pn], dsk[kk],
                desc(kb + pn * C::KV_PANEL + 16 * C::ROWB * kk, C::ROWB));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn) fence_regs(acc[pn]);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) fence_regs(dsk[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // stage s is free
    }

    // epilogue: dQ of this thread's two rows, in bf16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + 8 * hh;
      if (row >= Tq) continue;
      __nv_bfloat16* qrow = dq + b * dq_sb + h * dq_sh + row * dq_st;
#pragma unroll
      for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
        for (int jb = 0; jb < C::PW / 8; ++jb) {
          const int col = pn * C::PW + 8 * jb + 2 * quad;
          const int i = 4 * jb + 2 * hh;
          *reinterpret_cast<__nv_bfloat162*>(qrow + col) =
              __floats2bfloat162_rn(acc[pn][i], acc[pn][i + 1]);
        }
    }
  }
}

// st: (batch, head, token) element strides of q, k, v, dO (tensor maps)
// and dQ
template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H,
           int Tq, int Tk, const long long* st, float scale, int causal,
           cudaStream_t stream) {
  using C = Cfg<D, NWG>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int e = make_bthd_map(&tm_q, q, B, H, Tq, D, st[0], st[1], st[2], C::PW,
                        64);
  if (!e) e = make_bthd_map(&tm_k, k, B, H, Tk, D, st[3], st[4], st[5],
                            C::PW, C::BK);
  if (!e) e = make_bthd_map(&tm_v, v, B, H, Tk, D, st[6], st[7], st[8],
                            C::PW, C::BK);
  if (!e) e = make_bthd_map(&tm_do, dout, B, H, Tq, D, st[9], st[10],
                            st[11], C::PW, 64);
  if (e) return TENSOR_MAP_ERROR + e;
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_sm90_kernel<D, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Tq + 64 * NWG - 1) / (64 * NWG), B * H);
  flash_bwd_dq_sm90_kernel<D, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dq),
      H, Tq, Tk, st[12], st[13], st[14], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int NWG>
int dispatch_d(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, int B, int H,
               int Tq, int Tk, int D, const long long* st, float scale,
               int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, NWG>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, s);
    case 32: return launch<32, NWG>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, s);
    case 64: return launch<64, NWG>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, s);
    case 128: return launch<128, NWG>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16 q, k, v, dO, dQ as [B, H, T, D] views with element strides (batch,
// head, token) and a contiguous last dim; lse and delta contiguous fp32
// [B, H, Tq]; Tq, Tk >= 1. Returns 0 when launched, a cudaError_t code, or
// 10000 + the CUresult of a tensor map that cuTensorMapEncodeTiled refused.
extern "C" int ds_flash_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Tq,
    int Tk, int D, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long do_sb, long long do_sh,
    long long do_st, long long dq_sb, long long dq_sh, long long dq_st,
    float scale, int causal, void* stream) {
  const long long st[15] = {q_sb,  q_sh,  q_st,  k_sb,  k_sh,
                            k_st,  v_sb,  v_sh,  v_st,  do_sb,
                            do_sh, do_st, dq_sb, dq_sh, dq_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  // 128 query rows a CTA where that fills the SMs, else 64
  const long long ctas_128 = static_cast<long long>(B) * H * ((Tq + 127) / 128);
  if (ctas_128 >= sm_count())
    return dispatch_d<2>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, D, st, scale,
                         causal, s);
  return dispatch_d<1>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, D, st, scale,
                       causal, s);
}
