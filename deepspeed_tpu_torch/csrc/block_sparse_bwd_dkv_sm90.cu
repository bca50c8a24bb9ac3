// Block-sparse attention backward, dK/dV pass, for Hopper (sm_90a) on the
// tensor cores, bf16.
//
// Replaces the TPU kernel _bwd_dkv_kernel of
// deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py (:214, launched
// by _sparse_backward at :311, which walks the transposed entry list) for
// bf16 inputs whose block is a multiple of 64; fp32, and bf16 blocks of 16,
// 32, 48, 80, ..., stay on block_sparse_bwd_dkv.cu's CUDA-core kernel. The
// TPU kernel's rounding points are kept: p = exp(s * scale - lse) in fp32
// from the forward's logsumexp, dV += bf16(p)^T . dO (p.astype(do.dtype)),
// ds = p * (dp - delta) * scale from the unrounded p with dp = dO . V^T,
// and dK += bf16(ds)^T . Q (ds.astype(q.dtype)), both sums in fp32; delta =
// rowsum(dO * O) comes from the caller in fp32. Every pair inside an active
// block is visible, S and the block are multiples of 64 and no column is
// empty (the wrapper's check_layout), so no tile is masked.
//
// What bounds it on the H100: operations. At the sparse BERT slice's shape
// (B=2 H=16 S=4096 D=64, fixed per-head layout, block 128, 184.5 M visible
// pairs) it does 8 * D flops a pair, 9.5e10 bf16 flops, 0.096 ms at 989
// TF/s, against 102 MB of q, k, v, dO, dK, dV, lse and delta, 0.030 ms at
// 3.35 TB/s. On the fp32 CUDA cores (67 TF/s) the same work needs 1.4 ms at
// least, so only wgmma comes near the bound. Design: flash_bwd_dkv_sm90.cu's,
// with the tile walk taken from the layout's CSC lists, on the building
// blocks of sm90_common.cuh:
// - one CTA owns 64 * NWG key rows inside one key block of one (batch,
//   head): NWG = 2 where the block is a multiple of 128, else 1. Its one
//   producer warp loads the CTA's K and V rows once by TMA, then walks the
//   column's query blocks row_idx[col_ptr[h * nk + j] .. col_ptr[h * nk + j
//   + 1]), each as block / 64 tiles of 64 queries, through a ring of STAGES
//   stages: Q and dO by TMA at token row_idx[e] * block + 64 t on one
//   mbarrier, lse (pre-scaled by log2 e) and delta by plain loads of its 32
//   lanes on another;
// - the consumer warpgroups own 64 key rows each and share every tile. They
//   compute the transposed scores S^T = K.Q^T and dP^T = V.dO^T with the
//   keys as the M side (wgmma.m64n64k16, both operands K-major from
//   swizzled shared memory), so P^T and dS^T come out by key rows, already
//   wgmma's A-fragment layout: p and ds are rounded to bf16 in registers
//   and dV += P^T.dO, dK += dS^T.Q are wgmma with A from registers and dO,
//   Q read MN-major from the same stage. Each tile waits for its stage
//   first, then issues and retires all its products with no barrier wait
//   or branch in between (ptxas serializes a wgmma in flight across one);
// - dK and dV stay in fp32 registers across the whole walk and are written
//   once, in bf16, through the output strides: no atomics, no second pass;
// - the columns' walks have uneven lengths (the slice's 128 global columns
//   take 32 query blocks, the other 384 take 4), so the CTA index maps
//   through `order`, the (head, key block) pairs sorted by column length,
//   longest first (BlockLists.dkv_order, built once with the lists): the
//   longest walks start in the first wave and the short ones fill the
//   tail, where grid order could start a 64-tile walk in the last wave.
// Head dim 64; q, k, v, dO through tensor maps over their (batch, head,
// token) strides (the wrapper checks TMA's 16-byte rule), dK and dV
// through theirs; lse and delta contiguous [B, H, Sq] fp32.

#include <cmath>
#include <cstdint>

#include "sm90_common.cuh"

using namespace dsport;
using namespace dsport::sm90;

namespace {

constexpr int D = 64;        // head dim: one panel of 128-byte rows
constexpr int ROWB = 2 * D;  // bytes a row = the swizzle's width
constexpr int BQ = 64;       // queries a tile
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;

template <int NWG>
struct Cfg {
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int KV_PANEL = 64 * ROWB;        // one warpgroup's keys
  static constexpr int KV_BYTES = NWG * KV_PANEL;   // the CTA's K or V
  static constexpr int Q_BYTES = BQ * ROWB;         // one Q or dO tile
  // a stage: Q, dO, then lse and delta (BQ floats each), padded to keep
  // the next stage on the 128-byte swizzle's 1024-byte atom
  static constexpr int STAT_OFF = 2 * Q_BYTES;
  static constexpr int STAGE_BYTES = 2 * Q_BYTES + 1024;
  static constexpr int RING_OFF = 2 * KV_BYTES;
  static constexpr int BAR_OFF = RING_OFF + STAGES * STAGE_BYTES;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's atom
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
};

template <int NWG>
__global__ void __launch_bounds__(Cfg<NWG>::THREADS, 1)
block_sparse_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                 const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v,
                                 const __grid_constant__ CUtensorMap tm_do,
                                 const float* __restrict__ lse,
                                 const float* __restrict__ delta,
                                 __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv,
                                 const int* __restrict__ col_ptr,
                                 const int* __restrict__ row_idx,
                                 const int* __restrict__ order, int B, int H,
                                 int Sq, int Sk, int block, long long dk_sb,
                                 long long dk_sh, long long dk_st,
                                 long long dv_sb, long long dv_sh,
                                 long long dv_st, float scale) {
  using C = Cfg<NWG>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const sbase = smem_raw + (base - raw);  // generic view of base
  const uint32_t bar_kv = base + C::BAR_OFF;
  const uint32_t bar_full = bar_kv + 8;  // Q and dO by TMA
  const uint32_t bar_full_st = bar_full + 8 * STAGES;  // lse and delta
  const uint32_t bar_empty = bar_full_st + 8 * STAGES;

  // the CTA's (head, key block) from the longest-first order, then its
  // batch and its 64 * NWG rows inside the block
  const int nk = Sk / block;
  const int per_block = block / (64 * NWG);
  const int pair = order[blockIdx.x / (per_block * B)];
  const int rest = blockIdx.x % (per_block * B);
  const int b = rest / per_block;
  const int h = pair / nk;
  const int k0 = (pair % nk) * block + (rest % per_block) * 64 * NWG;
  const int bh = b * H + h;
  const int e_begin = col_ptr[pair];
  const int tiles_a_block = block / BQ;
  const int n_tiles = (col_ptr[pair + 1] - e_begin) * tiles_a_block;

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
  // are then not divergent
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {
    // ---------------- producer: warp 0 of the last warpgroup
    const int lane = threadIdx.x - NWG * 128;
    if (lane < 32) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
        for (int w = 0; w < NWG; ++w) {
          const uint32_t at = w * C::KV_PANEL;
          tma_load_4d(base + at, &tm_k, bar_kv, 0, k0 + 64 * w, h, b);
          tma_load_4d(base + C::KV_BYTES + at, &tm_v, bar_kv, 0, k0 + 64 * w,
                      h, b);
        }
      }
      const float* lse_bh = lse + static_cast<long long>(bh) * Sq;
      const float* delta_bh = delta + static_cast<long long>(bh) * Sq;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int qt0 = row_idx[e_begin + t / tiles_a_block] * block +
                        (t % tiles_a_block) * BQ;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, (t / STAGES - 1) & 1);
        const uint32_t sb = base + C::RING_OFF + s * C::STAGE_BYTES;
        if (lane == 0) {
          mbar_expect_tx(bar_full + 8 * s, 2 * C::Q_BYTES);
          tma_load_4d(sb, &tm_q, bar_full + 8 * s, 0, qt0, h, b);
          tma_load_4d(sb + C::Q_BYTES, &tm_do, bar_full + 8 * s, 0, qt0, h,
                      b);
        }
        float* st = reinterpret_cast<float*>(sbase + (sb - base) +
                                             C::STAT_OFF);
        for (int i = lane; i < BQ; i += 32) {
          st[i] = lse_bh[qt0 + i] * LOG2E;
          st[BQ + i] = delta_bh[qt0 + i];
        }
        mbar_arrive(bar_full_st + 8 * s);
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns 64 key rows
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    const int key0 = k0 + 64 * wg + 16 * warp + lane / 4;  // and key0 + 8
    const uint32_t ka = base + wg * C::KV_PANEL;
    const uint32_t va = ka + C::KV_BYTES;
    const float scale_log2 = scale * LOG2E;

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const uint32_t qs = base + C::RING_OFF + s * C::STAGE_BYTES;
      const uint32_t dos = qs + C::Q_BYTES;
      const float2* lse2 = reinterpret_cast<const float2*>(
          sbase + (qs - base) + C::STAT_OFF);
      const float2* delta2 = lse2 + BQ / 2;
      float sc[BQ / 2], dp[BQ / 2];
      uint32_t pk[BQ / 16][4], dsk[BQ / 16][4];

      mbar_wait(bar_full + 8 * s, parity);
      mbar_wait(bar_full_st + 8 * s, parity);
      // S^T = K . Q^T, then dP^T = V . dO^T, which runs while p is computed
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<BQ>::run(sc, desc(ka + 32 * kk, ROWB),
                         desc(qs + 32 * kk, ROWB), kk != 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<BQ>::run(dp, desc(va + 32 * kk, ROWB),
                         desc(dos + 32 * kk, ROWB), kk != 0);
      wgmma_commit();
      wgmma_wait<1>();  // S^T has landed
      fence_regs(sc);
      // p = exp(s * scale - lse): every pair of the tile is visible
#pragma unroll
      for (int g = 0; g < BQ / 8; ++g) {
        const float2 l = lse2[4 * g + quad];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * g + e;
          sc[i] = exp2f(sc[i] * scale_log2 - ((e & 1) ? l.y : l.x));
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
      // p and ds rounded to bf16: the 16 columns (queries) of slice kk are
      // the A fragments of dV += P^T . dO and dK += dS^T . Q for queries
      // 16 kk .. 16 kk + 15 (packing both before either product frees the
      // fp32 P^T and dS^T, which two warpgroups' 168 registers a thread
      // could not hold beside dK, dV and the bf16 copies)
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j;
          pk[kk][j] = pack_bf16(sc[i], sc[i + 1]);
          dsk[kk][j] = pack_bf16(dp[i], dp[i + 1]);
        }
      fence_regs(acc_k);
      fence_regs(acc_v);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        fence_regs(pk[kk]);
        fence_regs(dsk[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        WgmmaRS<D>::run(acc_v, pk[kk], desc(dos + 16 * ROWB * kk, ROWB));
        WgmmaRS<D>::run(acc_k, dsk[kk], desc(qs + 16 * ROWB * kk, ROWB));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_k);
      fence_regs(acc_v);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        fence_regs(pk[kk]);
        fence_regs(dsk[kk]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // stage s is free
    }

    // epilogue: dK and dV of this thread's two key rows, in bf16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long key = key0 + 8 * hh;
      __nv_bfloat16* krow = dk + b * dk_sb + h * dk_sh + key * dk_st;
      __nv_bfloat16* vrow = dv + b * dv_sb + h * dv_sh + key * dv_st;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const int col = 8 * jb + 2 * quad;
        const int i = 4 * jb + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(krow + col) =
            __floats2bfloat162_rn(acc_k[i], acc_k[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(vrow + col) =
            __floats2bfloat162_rn(acc_v[i], acc_v[i + 1]);
      }
    }
  }
}

// st: (batch, head, token) element strides of q, k, v, dO (tensor maps),
// dK and dV
template <int NWG>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv,
           const int* col_ptr, const int* row_idx, const int* order, int B,
           int H, int Sq, int Sk, int block, const long long* st, float scale,
           cudaStream_t stream) {
  using C = Cfg<NWG>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int e = make_bthd_map(&tm_q, q, B, H, Sq, D, st[0], st[1], st[2], D, BQ);
  if (!e) e = make_bthd_map(&tm_k, k, B, H, Sk, D, st[3], st[4], st[5], D,
                            64);
  if (!e) e = make_bthd_map(&tm_v, v, B, H, Sk, D, st[6], st[7], st[8], D,
                            64);
  if (!e) e = make_bthd_map(&tm_do, dout, B, H, Sq, D, st[9], st[10], st[11],
                            D, BQ);
  if (e) return TENSOR_MAP_ERROR + e;
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        block_sparse_bwd_dkv_sm90_kernel<NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // one CTA per 64 * NWG key rows of every (batch, head, key block)
  const unsigned grid = static_cast<unsigned>(B) * H * (Sk / (64 * NWG));
  block_sparse_bwd_dkv_sm90_kernel<NWG><<<grid, C::THREADS, C::SMEM,
                                          stream>>>(
      tm_q, tm_k, tm_v, tm_do, lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), col_ptr, row_idx, order, B, H, Sq, Sk,
      block, st[12], st[13], st[14], st[15], st[16], st[17], scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, dO, dK, dV as [B, H, S, 64] views with element strides
// (batch, head, token) and a contiguous last dim; lse and delta contiguous
// fp32 [B, H, Sq]. col_ptr [H * nk + 1] and row_idx int32 on the device:
// key block j of head h is attended by the query blocks row_idx[col_ptr[h *
// nk + j] .. col_ptr[h * nk + j + 1]), none empty; order [H * nk] int32,
// the pairs h * nk + j longest column first. Returns 0 when launched, a
// cudaError_t code (cudaErrorInvalidValue for a head dim other than 64, or
// a block that is not a multiple of 64 dividing Sq and Sk), or 10000 + the
// CUresult of a tensor map that cuTensorMapEncodeTiled refused.
extern "C" int ds_block_sparse_bwd_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const void* col_ptr, const void* row_idx, const void* order, int B, int H,
    int Sq, int Sk, int Dh, int block, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long do_sb,
    long long do_sh, long long do_st, long long dk_sb, long long dk_sh,
    long long dk_st, long long dv_sb, long long dv_sh, long long dv_st,
    float scale, void* stream) {
  if (Dh != D || block < 64 || block % 64 || Sq % block || Sk % block)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[18] = {q_sb,  q_sh,  q_st,  k_sb,  k_sh,  k_st,
                            v_sb,  v_sh,  v_st,  do_sb, do_sh, do_st,
                            dk_sb, dk_sh, dk_st, dv_sb, dv_sh, dv_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* cp = static_cast<const int*>(col_ptr);
  const int* ri = static_cast<const int*>(row_idx);
  const int* od = static_cast<const int*>(order);
  // two consumer warpgroups (128 keys a CTA) where the block holds them
  if (block % 128 == 0)
    return launch<2>(q, k, v, dout, l, dl, dk, dv, cp, ri, od, B, H, Sq, Sk,
                     block, st, scale, s);
  return launch<1>(q, k, v, dout, l, dl, dk, dv, cp, ri, od, B, H, Sq, Sk,
                   block, st, scale, s);
}
