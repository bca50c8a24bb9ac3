// Flash attention forward for Hopper (sm_90a) on the tensor cores, bf16.
//
// Replaces the TPU kernel _fwd_kernel (deepspeed_tpu/ops/flash_attention.py:77,
// launched by _flash_forward at :174) and, through the strides of the
// tensor maps, _fwd_kernel_bthd (:504, launched at :545) for bf16 inputs;
// fp32 stays on flash_fwd.cu's CUDA-core kernel, since the tensor cores
// would round fp32 operands to TF32. The TPU kernel's rounding points are
// kept: s = (q.k) * scale in fp32, the bottom-right causal mask (row i sees
// keys <= i + Tk - Tq), fp32 running max and sum, the unnormalised p
// rounded to bf16 before P.V while the sum takes it unrounded, O = acc / l
// with l == 0 (a fully masked row) giving O = 0, and lse = m + log(l) in
// fp32 ([B, H, Tq], read by the unchanged backward kernels).
//
// What bounds it on the H100: bytes and operations about equally. At
// GPT-2's training shape (B=16 H=12 T=1024 D=64, causal) it reads q, k, v
// and writes O, 101 MB (0.030 ms at 3.35 TB/s), and does 25.8 GFLOP of
// bf16 products (0.026 ms at 989 TF/s); shorter rows are bound by bytes.
// Only the tensor cores reach either rate, and exp2 of every score on the
// special-function units comes next. Design, one CTA per (64 * NWG query
// rows, batch x head):
// - one producer warp issues TMA loads: the CTA's Q rows once, then K and V
//   tiles of BK keys into a ring of STAGES shared-memory stages, each full
//   stage signalled on an mbarrier (K and V apart, so Q.K^T starts before V
//   lands) and released by the consumers on another; tiles above the
//   causal limit of the CTA's last row are never loaded, and rows past T
//   read as zeros (TMA's out-of-bounds fill);
// - NWG consumer warpgroups own 64 query rows each. S = Q.K^T is one
//   wgmma.m64nBKk16 per 16-deep slice of the head dim, Q and K both
//   K-major from swizzled shared memory; the online softmax runs on the
//   fp32 accumulator fragments (a row's max and sum across the four
//   threads of a quad by shuffles; masks only on the diagonal and ragged
//   tiles; exp2 of scores pre-scaled by log2 e); P is converted to bf16 in
//   registers, where the accumulator layout is already wgmma's A-fragment
//   layout, and O += P.V is wgmma with A from registers and V MN-major
//   from shared memory (the instruction transposes it);
// - with two consumer warpgroups setmaxnreg moves registers from the
//   producer (24) to the consumers (240);
// - 128 query rows a CTA (NWG = 2) where B * H * ceil(Tq / 128) fills the
//   SMs, else 64 (NWG = 1: the serving prefill at B = 1); the CTAs of the
//   longest causal rows start first.
// Head dims 16, 32, 64 (one panel of 32-, 64- or 128-byte rows) and 128
// (two 64-wide panels); any T; q, k, v, o through their strides (last dim
// contiguous; the wrapper checks TMA's 16-byte rule).

#include <cmath>
#include <cstdint>

#include "attention_common.cuh"
#include "sm90_common.cuh"

using namespace dsport;
using namespace dsport::sm90;

namespace {

constexpr int STAGES = 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D, int NWG>
struct Cfg {
  static constexpr int PW = D < 64 ? D : 64;  // panel width (elements)
  static constexpr int NP = D / PW;           // panels of the head dim
  static constexpr int ROWB = 2 * PW;         // bytes a panel row = swizzle
  static constexpr int BK = D == 128 ? 64 : 128;  // keys a tile
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int Q_PANEL = 64 * ROWB;   // one warpgroup's rows
  static constexpr int Q_BYTES = NWG * NP * Q_PANEL;
  static constexpr int KV_PANEL = BK * ROWB;
  static constexpr int KV_BYTES = NP * KV_PANEL;  // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's atom
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
};

template <int D, int NWG>
__global__ void __launch_bounds__(Cfg<D, NWG>::THREADS, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                      int H, int Tq, int Tk, long long o_sb, long long o_sh,
                      long long o_st, float scale_log2, int causal) {
  using C = Cfg<D, NWG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + C::BAR_OFF;
  const uint32_t bar_full_k = bar_q + 8;
  const uint32_t bar_full_v = bar_full_k + 8 * STAGES;
  const uint32_t bar_empty = bar_full_v + 8 * STAGES;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 64 * NWG;
  const int off = Tk - Tq;  // bottom-right causal alignment
  // keys the CTA's last row can see: the causal limit of the loads
  const int q_last = min(q0 + 64 * NWG, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + off + 1) : Tk;
  const int n_tiles = k_end > 0 ? (k_end + C::BK - 1) / C::BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * NWG);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NWG) {
    // ---------------- producer: one thread issues every TMA load
    if constexpr (NWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int w = 0; w < NWG; ++w)
        for (int pn = 0; pn < C::NP; ++pn)
          tma_load_4d(base + (w * C::NP + pn) * C::Q_PANEL, &tm_q, bar_q,
                      pn * C::PW, q0 + 64 * w, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, (t / STAGES - 1) & 1);
        const uint32_t kb = base + C::Q_BYTES + s * 2 * C::KV_BYTES;
        mbar_expect_tx(bar_full_k + 8 * s, C::KV_BYTES);
        for (int pn = 0; pn < C::NP; ++pn)
          tma_load_4d(kb + pn * C::KV_PANEL, &tm_k, bar_full_k + 8 * s,
                      pn * C::PW, t * C::BK, h, b);
        mbar_expect_tx(bar_full_v + 8 * s, C::KV_BYTES);
        for (int pn = 0; pn < C::NP; ++pn)
          tma_load_4d(kb + C::KV_BYTES + pn * C::KV_PANEL, &tm_v,
                      bar_full_v + 8 * s, pn * C::PW, t * C::BK, h, b);
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns 64 query rows
    if constexpr (NWG == 2) setmaxnreg_inc<240>();
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

    float acc[C::NP][C::PW / 2];
#pragma unroll
    for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
      for (int i = 0; i < C::PW / 2; ++i) acc[pn][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const int k0 = t * C::BK;
      // a tile wholly above this warpgroup's causal limit is not computed
      // (the warpgroup still takes part in the stage's hand-over)
      const bool active = k0 < k_end_wg;
      const uint32_t kb = base + C::Q_BYTES + s * 2 * C::KV_BYTES;
      const uint32_t vb = kb + C::KV_BYTES;
      uint32_t p[C::BK / 16][4];

      mbar_wait(bar_full_k + 8 * s, parity);
      if (active) {
        float sc[C::BK / 2];
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
          for (int kk = 0; kk < C::PW / 16; ++kk)
            WgmmaSS<C::BK>::run(
                sc, desc(qa + pn * C::Q_PANEL + 32 * kk, C::ROWB),
                desc(kb + pn * C::KV_PANEL + 32 * kk, C::ROWB),
                (pn | kk) != 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        // scores in log2 units; masked keys -inf (only the tiles that the
        // diagonal or the ragged end crosses)
        const bool masked = k0 + C::BK > Tk ||
                            (causal && k0 + C::BK - 1 > wq0 + off);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < C::BK / 2; ++i) {
          const int hh = (i >> 1) & 1;
          float x = sc[i] * scale_log2;
          if (masked) {
            const int col = k0 + 8 * (i >> 2) + 2 * quad + (i & 1);
            if (col >= Tk || (causal && col > row0 + 8 * hh + off))
              x = -INFINITY;
          }
          sc[i] = x;
          mx[hh] = fmaxf(mx[hh], x);
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
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < C::BK / 2; ++i) {
          const int hh = (i >> 1) & 1;
          sc[i] = exp2f(sc[i] - mu[hh]);
          rs[hh] += sc[i];
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
          for (int i = 0; i < C::PW / 2; ++i)
            acc[pn][i] *= alpha[(i >> 1) & 1];
        // p rounded to bf16: the accumulator's 16 columns of slice kk are
        // the A fragment of the P.V wgmma for keys 16 kk .. 16 kk + 15
#pragma unroll
        for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            p[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
      }

      mbar_wait(bar_full_v + 8 * s, parity);
      if (active) {
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn) fence_regs(acc[pn]);
#pragma unroll
        for (int kk = 0; kk < C::BK / 16; ++kk) fence_regs(p[kk]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
          for (int pn = 0; pn < C::NP; ++pn)
            WgmmaRS<C::PW>::run(
                acc[pn], p[kk],
                desc(vb + pn * C::KV_PANEL + 16 * C::ROWB * kk, C::ROWB));
        wgmma_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int pn = 0; pn < C::NP; ++pn) fence_regs(acc[pn]);
#pragma unroll
        for (int kk = 0; kk < C::BK / 16; ++kk) fence_regs(p[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // stage s is free
    }

    // epilogue: the row sums across the quad, O = acc / l, lse
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      const int row = row0 + 8 * hh;
      if (row >= Tq) continue;
      const float safe_l = l[hh] == 0.f ? 1.f : l[hh];
      __nv_bfloat16* orow = o + b * o_sb + h * o_sh + row * o_st;
#pragma unroll
      for (int pn = 0; pn < C::NP; ++pn)
#pragma unroll
        for (int jb = 0; jb < C::PW / 8; ++jb) {
          const int col = pn * C::PW + 8 * jb + 2 * quad;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(
                  __fdiv_rn(acc[pn][4 * jb + 2 * hh], safe_l),
                  __fdiv_rn(acc[pn][4 * jb + 2 * hh + 1], safe_l));
        }
      if (quad == 0)
        lse[static_cast<long long>(bh) * Tq + row] =
            l[hh] == 0.f ? NEG_INF : (m[hh] + log2f(l[hh])) * LN2;
    }
  }
}

template <int D, int NWG>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  using C = Cfg<D, NWG>;
  CUtensorMap tm_q, tm_k, tm_v;
  // an empty K/V keeps a one-row map that no tile ever loads
  const int tk_map = Tk > 0 ? Tk : 1;
  int e = make_bthd_map(&tm_q, q, B, H, Tq, D, st[0], st[1], st[2], C::PW, 64);
  if (!e) e = make_bthd_map(&tm_k, k, B, H, tk_map, D, st[3], st[4], st[5],
                            C::PW, C::BK);
  if (!e) e = make_bthd_map(&tm_v, v, B, H, tk_map, D, st[6], st[7], st[8],
                            C::PW, C::BK);
  if (e) return TENSOR_MAP_ERROR + e;
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90_kernel<D, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((Tq + 64 * NWG - 1) / (64 * NWG), B * H);
  flash_fwd_sm90_kernel<D, NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, H, Tq, Tk,
      st[9], st[10], st[11], scale * LOG2E, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int NWG>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Tq, int Tk, int D,
               const long long* st, float scale, int causal,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<16, NWG>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, stream);
    case 32: return launch<32, NWG>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, stream);
    case 64: return launch<64, NWG>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, stream);
    case 128: return launch<128, NWG>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16 q, k, v, o as [B, H, T, D] views with element strides (batch, head,
// token) and a contiguous last dim; lse contiguous fp32 [B, H, Tq]. Returns
// 0 when launched, a cudaError_t code, or 10000 + the CUresult of a tensor
// map that cuTensorMapEncodeTiled refused.
extern "C" int ds_flash_fwd_sm90(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int B, int H, int Tq,
                                 int Tk, int D, long long q_sb, long long q_sh,
                                 long long q_st, long long k_sb,
                                 long long k_sh, long long k_st,
                                 long long v_sb, long long v_sh,
                                 long long v_st, long long o_sb,
                                 long long o_sh, long long o_st, float scale,
                                 int causal, void* stream) {
  const long long st[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                            v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  // 128 query rows a CTA where that fills the SMs, else 64
  const long long ctas_128 = static_cast<long long>(B) * H * ((Tq + 127) / 128);
  if (ctas_128 >= sm_count())
    return dispatch_d<2>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, causal, s);
  return dispatch_d<1>(q, k, v, o, l, B, H, Tq, Tk, D, st, scale, causal, s);
}
