// Block-sparse attention backward, dQ pass, for Hopper (sm_90a) on the
// tensor cores, bf16.
//
// Replaces the TPU kernel _bwd_dq_kernel of
// deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py (:175, launched
// by _sparse_backward at :280) for bf16 inputs whose block is a multiple of
// 64; fp32, and bf16 blocks of 16, 32, 48, 80, ..., stay on
// block_sparse_bwd_dq.cu's CUDA-core kernel. The TPU kernel's rounding
// points are kept: p = exp(s * scale - lse) in fp32 from the forward's
// logsumexp, ds = p * (dp - delta) * scale with dp = dO . V^T, rounded to
// bf16 (ds.astype(k.dtype)), and dQ += ds . K summed in fp32 and written
// once in bf16; delta = rowsum(dO * O) comes from the caller in fp32. Every
// pair inside an active block is visible, S and the block are multiples of
// 64 and no row is empty (the wrapper's check_layout), so no tile is masked.
//
// What bounds it on the H100: operations. At the sparse BERT slice's shape
// (B=2 H=16 S=4096 D=64, fixed per-head layout, block 128, 184.5 M visible
// pairs) it does 6 * D flops a pair, 7.1e10 bf16 flops, 0.072 ms at 989
// TF/s, against 85 MB of q, k, v, dO, dQ, lse and delta, 0.025 ms at 3.35
// TB/s; on the fp32 CUDA cores (67 TF/s) it needs 1.06 ms at least. Design:
// flash_bwd_dq_sm90.cu's, with the tile walk taken from the layout's CSR
// lists, on the building blocks of sm90_common.cuh:
// - one CTA owns 64 * NWG query rows inside one query block of one (batch,
//   head): NWG = 2 where the block is a multiple of 128, else 1. Its
//   producer thread loads the CTA's Q and dO rows once by TMA, then walks
//   the row's key blocks col_idx[row_ptr[h * nq + i] .. row_ptr[h * nq + i
//   + 1]), each as block / 64 tiles of BK = 64 keys of K and V at token
//   col_idx[e] * block + 64 t, through a ring of STAGES stages (one
//   mbarrier signals a full stage, another its release by the consumers);
// - the consumer warpgroups own 64 query rows each and read their rows' lse
//   and delta once. On each tile S = Q.K^T and dP = dO.V^T are
//   wgmma.m64n64k16 (K-major operands from swizzled shared memory; dP runs
//   while p is computed), ds is rounded to bf16 in registers, where the
//   accumulator layout is already wgmma's A-fragment layout, and dQ +=
//   dS.K is wgmma with A from registers and K read MN-major from the stage.
//   Each tile waits for its stage first, then issues and retires all its
//   products with no barrier wait or branch in between;
// - dQ stays in fp32 registers across the whole walk and is written once,
//   in bf16, through its strides: no atomics, no second pass;
// - the CTA index maps through `order`, the (head, query block) pairs
//   sorted by row length, longest first (BlockLists.dq_order): the slice's
//   rows are even (11 key blocks each), BigBird's are not.
// Head dim 64; q, k, v, dO through tensor maps over their (batch, head,
// token) strides (the wrapper checks TMA's 16-byte rule), dQ through its
// own; lse and delta contiguous [B, H, Sq] fp32.

#include <cmath>
#include <cstdint>

#include "sm90_common.cuh"

using namespace dsport;
using namespace dsport::sm90;

namespace {

constexpr int D = 64;        // head dim: one panel of 128-byte rows
constexpr int ROWB = 2 * D;  // bytes a row = the swizzle's width
constexpr int BK = 64;       // keys a tile
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

template <int NWG>
struct Cfg {
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int Q_PANEL = 64 * ROWB;       // one warpgroup's rows
  static constexpr int Q_BYTES = NWG * Q_PANEL;   // Q or dO of the CTA
  static constexpr int KV_BYTES = BK * ROWB;      // one K or V tile
  static constexpr int RING_OFF = 2 * Q_BYTES;
  static constexpr int BAR_OFF = RING_OFF + STAGES * 2 * KV_BYTES;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's atom
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 2 * STAGES);
};

template <int NWG>
__global__ void __launch_bounds__(Cfg<NWG>::THREADS, 1)
block_sparse_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dq,
                                const int* __restrict__ row_ptr,
                                const int* __restrict__ col_idx,
                                const int* __restrict__ order, int B, int H,
                                int Sq, int block, long long dq_sb,
                                long long dq_sh, long long dq_st,
                                float scale) {
  using C = Cfg<NWG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + C::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;  // a K and V tile
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  // the CTA's (head, query block) from the longest-first order, then its
  // batch and its 64 * NWG rows inside the block
  const int nq = Sq / block;
  const int per_block = block / (64 * NWG);
  const int pair = order[blockIdx.x / (per_block * B)];
  const int rest = blockIdx.x % (per_block * B);
  const int b = rest / per_block;
  const int h = pair / nq;
  const int q0 = (pair % nq) * block + (rest % per_block) * 64 * NWG;
  const int e_begin = row_ptr[pair];
  const int tiles_a_block = block / BK;
  const int n_tiles = (row_ptr[pair + 1] - e_begin) * tiles_a_block;

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
  // are then not divergent
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {
    // ---------------- producer: one thread issues every TMA load
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
      for (int w = 0; w < NWG; ++w) {
        const uint32_t at = w * C::Q_PANEL;
        tma_load_4d(base + at, &tm_q, bar_q, 0, q0 + 64 * w, h, b);
        tma_load_4d(base + C::Q_BYTES + at, &tm_do, bar_q, 0, q0 + 64 * w, h,
                    b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int kt0 = col_idx[e_begin + t / tiles_a_block] * block +
                        (t % tiles_a_block) * BK;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, (t / STAGES - 1) & 1);
        const uint32_t kb = base + C::RING_OFF + s * 2 * C::KV_BYTES;
        mbar_expect_tx(bar_full + 8 * s, 2 * C::KV_BYTES);
        tma_load_4d(kb, &tm_k, bar_full + 8 * s, 0, kt0, h, b);
        tma_load_4d(kb + C::KV_BYTES, &tm_v, bar_full + 8 * s, 0, kt0, h, b);
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns 64 query rows
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
    const uint32_t qa = base + wg * C::Q_PANEL;
    const uint32_t doa = qa + C::Q_BYTES;
    const float scale_log2 = scale * LOG2E;
    // this thread's two rows' lse (log2 units) and delta
    float lse2[2], dl[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long at =
          (static_cast<long long>(b) * H + h) * Sq + row0 + 8 * hh;
      lse2[hh] = lse[at] * LOG2E;
      dl[hh] = delta[at];
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const uint32_t kb = base + C::RING_OFF + s * 2 * C::KV_BYTES;
      const uint32_t vb = kb + C::KV_BYTES;
      float sc[BK / 2], dp[BK / 2];
      uint32_t dsk[BK / 16][4];

      mbar_wait(bar_full + 8 * s, parity);
      // S = Q . K^T, then dP = dO . V^T, which runs while p is computed
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<BK>::run(sc, desc(qa + 32 * kk, ROWB),
                         desc(kb + 32 * kk, ROWB), kk != 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<BK>::run(dp, desc(doa + 32 * kk, ROWB),
                         desc(vb + 32 * kk, ROWB), kk != 0);
      wgmma_commit();
      wgmma_wait<1>();  // S has landed
      fence_regs(sc);
      // p = exp(s * scale - lse): every pair of the tile is visible
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        sc[i] = exp2f(sc[i] * scale_log2 - lse2[(i >> 1) & 1]);
      wgmma_wait<0>();  // dP has landed
      fence_regs(dp);
      // ds = p * (dp - delta) * scale rounded to bf16: the accumulator's
      // 16 columns of slice kk are the A fragment of dQ += dS . K for keys
      // 16 kk .. 16 kk + 15
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          const float d = dl[j & 1];
          dsk[kk][j] = pack_bf16(sc[i] * (dp[i] - d) * scale,
                                 sc[i + 1] * (dp[i + 1] - d) * scale);
        }
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(dsk[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaRS<D>::run(acc, dsk[kk], desc(kb + 16 * ROWB * kk, ROWB));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(dsk[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // stage s is free
    }

    // epilogue: dQ of this thread's two rows, in bf16
    const int quad = lane % 4;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long row = row0 + 8 * hh;
      __nv_bfloat16* qrow = dq + b * dq_sb + h * dq_sh + row * dq_st;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const int col = 8 * jb + 2 * quad;
        const int i = 4 * jb + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(qrow + col) =
            __floats2bfloat162_rn(acc[i], acc[i + 1]);
      }
    }
  }
}

// st: (batch, head, token) element strides of q, k, v, dO (tensor maps)
// and dQ
template <int NWG>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq,
           const int* row_ptr, const int* col_idx, const int* order, int B,
           int H, int Sq, int Sk, int block, const long long* st, float scale,
           cudaStream_t stream) {
  using C = Cfg<NWG>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int e = make_bthd_map(&tm_q, q, B, H, Sq, D, st[0], st[1], st[2], D, 64);
  if (!e) e = make_bthd_map(&tm_k, k, B, H, Sk, D, st[3], st[4], st[5], D,
                            BK);
  if (!e) e = make_bthd_map(&tm_v, v, B, H, Sk, D, st[6], st[7], st[8], D,
                            BK);
  if (!e) e = make_bthd_map(&tm_do, dout, B, H, Sq, D, st[9], st[10], st[11],
                            D, 64);
  if (e) return TENSOR_MAP_ERROR + e;
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        block_sparse_bwd_dq_sm90_kernel<NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // one CTA per 64 * NWG query rows of every (batch, head, query block)
  const unsigned grid = static_cast<unsigned>(B) * H * (Sq / (64 * NWG));
  block_sparse_bwd_dq_sm90_kernel<NWG><<<grid, C::THREADS, C::SMEM,
                                         stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dq),
      row_ptr, col_idx, order, B, H, Sq, block, st[12], st[13], st[14],
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, dO, dQ as [B, H, S, 64] views with element strides (batch,
// head, token) and a contiguous last dim; lse and delta contiguous fp32
// [B, H, Sq]. row_ptr [H * nq + 1] and col_idx int32 on the device: query
// block i of head h attends the key blocks col_idx[row_ptr[h * nq + i] ..
// row_ptr[h * nq + i + 1]), none empty; order [H * nq] int32, the pairs
// h * nq + i longest row first. Returns 0 when launched, a cudaError_t code
// (cudaErrorInvalidValue for a head dim other than 64, or a block that is
// not a multiple of 64 dividing Sq and Sk), or 10000 + the CUresult of a
// tensor map that cuTensorMapEncodeTiled refused.
extern "C" int ds_block_sparse_bwd_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const void* row_ptr,
    const void* col_idx, const void* order, int B, int H, int Sq, int Sk,
    int Dh, int block, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long do_sb, long long do_sh,
    long long do_st, long long dq_sb, long long dq_sh, long long dq_st,
    float scale, void* stream) {
  if (Dh != D || block < 64 || block % 64 || Sq % block || Sk % block)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[15] = {q_sb,  q_sh,  q_st,  k_sb,  k_sh,
                            k_st,  v_sb,  v_sh,  v_st,  do_sb,
                            do_sh, do_st, dq_sb, dq_sh, dq_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ci = static_cast<const int*>(col_idx);
  const int* od = static_cast<const int*>(order);
  // two consumer warpgroups (128 query rows a CTA) where the block holds
  // them
  if (block % 128 == 0)
    return launch<2>(q, k, v, dout, l, dl, dq, rp, ci, od, B, H, Sq, Sk,
                     block, st, scale, s);
  return launch<1>(q, k, v, dout, l, dl, dq, rp, ci, od, B, H, Sq, Sk, block,
                   st, scale, s);
}
