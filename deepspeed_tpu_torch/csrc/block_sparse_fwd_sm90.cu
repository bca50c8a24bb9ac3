// Block-sparse attention forward for Hopper (sm_90a) on the tensor cores,
// bf16.
//
// Replaces the TPU kernel _fwd_kernel of
// deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py (:79, launched
// by _sparse_forward_impl at :141) for bf16 inputs whose block is a
// multiple of 64; fp32, and bf16 blocks of 16, 32, 48, 80, ..., stay on
// block_sparse_fwd.cu's CUDA-core kernel (the tensor cores would round fp32
// to TF32). The TPU kernel's rounding points are kept: s = (q.k) * scale in
// fp32, an fp32 running max m and sum l, the unnormalised p rounded to bf16
// before P.V while l sums it unrounded, fp32 accumulation, O = acc / l
// written once in bf16 (l == 0 divides by 1), and lse = m + log(l) in fp32,
// contiguous [B, H, S] (read by the unchanged backward kernels). Every pair
// inside an active block is visible, S and the block are multiples of 64
// and no row is empty (the wrapper's check_layout), so no tile is masked.
//
// What bounds it on the H100: operations. At the sparse BERT slice's shape
// (B=2 H=16 S=4096 D=64, fixed per-head layout, block 128, 184.5 M visible
// pairs) it does 4 * D flops a pair, 4.7e10 bf16 flops, 0.048 ms at 989
// TF/s, against 68 MB of q, k, v, O and lse, 0.020 ms at 3.35 TB/s; on the
// fp32 CUDA cores (67 TF/s) the same products need 0.70 ms at least, so
// block_sparse_fwd.cu, which multiplies scalars from shared memory, cannot
// come near. Design: flash_fwd_sm90.cu's, with block_sparse_bwd_dq_sm90.cu's
// walk over the layout's CSR lists, on the building blocks of
// sm90_common.cuh:
// - one CTA owns 64 * NWG query rows inside one query block of one (batch,
//   head): NWG = 2 where the block is a multiple of 128, else 1. The CTA
//   index maps through `order`, the (head, query block) pairs sorted by row
//   length, longest first (BlockLists.dq_order: the forward walks the rows
//   dQ walks), so uneven rows (BigBird) start their long walks first;
// - one producer thread loads the CTA's Q rows once by TMA, then walks the
//   row's key blocks col_idx[row_ptr[h * nq + i] .. row_ptr[h * nq + i +
//   1]), each as block / BK tiles of BK = 64 * NWG keys of K and V at token
//   col_idx[e] * block + BK t, through a ring of STAGES stages: K and V of
//   a stage land on barriers of their own, so Q.K^T starts before V has
//   landed, and the consumers release the stage on a third;
// - the consumer warpgroups own 64 query rows each. S = Q.K^T is
//   wgmma.m64nBKk16 with both operands K-major in swizzled shared memory;
//   the online softmax runs on the fp32 accumulator fragments (a row's max
//   and sum across the four threads of a quad by shuffles, exp2 of scores
//   pre-scaled by log2 e); P is rounded to bf16 in registers, where the
//   accumulator layout is already wgmma's A-fragment layout, and O += P.V
//   is wgmma with A from registers and V MN-major from the stage. Each
//   tile's products are issued and retired with no barrier wait or branch
//   in between (a wgmma in flight across one is serialized);
// - O stays in fp32 registers across the whole walk and is written once,
//   in bf16, through its own strides, and lse contiguous: no atomics, no
//   second pass.
// Head dim 64; q, k, v through tensor maps over their (batch, head, token)
// strides (the wrapper checks TMA's 16-byte rule).

#include <cmath>
#include <cstdint>

#include "sm90_common.cuh"

using namespace dsport;
using namespace dsport::sm90;

namespace {

constexpr int D = 64;        // head dim: one panel of 128-byte rows
constexpr int ROWB = 2 * D;  // bytes a row = the swizzle's width
constexpr int STAGES = 3;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int NWG>
struct Cfg {
  static constexpr int BK = 64 * NWG;  // keys a tile
  static constexpr int THREADS = (NWG + 1) * 128;
  static constexpr int Q_PANEL = 64 * ROWB;      // one warpgroup's rows
  static constexpr int Q_BYTES = NWG * Q_PANEL;  // Q of the CTA
  static constexpr int KV_BYTES = BK * ROWB;     // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  // 1024 bytes of slack to align the tiles to the 128-byte swizzle's atom
  static constexpr int SMEM = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES);
};

template <int NWG>
__global__ void __launch_bounds__(Cfg<NWG>::THREADS, 1)
block_sparse_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             __nv_bfloat16* __restrict__ o,
                             float* __restrict__ lse,
                             const int* __restrict__ row_ptr,
                             const int* __restrict__ col_idx,
                             const int* __restrict__ order, int B, int H,
                             int Sq, int block, long long o_sb,
                             long long o_sh, long long o_st,
                             float scale_log2) {
  using C = Cfg<NWG>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + C::BAR_OFF;
  const uint32_t bar_full_k = bar_q + 8;
  const uint32_t bar_full_v = bar_full_k + 8 * STAGES;
  const uint32_t bar_empty = bar_full_v + 8 * STAGES;

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
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 4 * NWG);  // one arrival a consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup, read from lane 0 so that the compiler knows it is
  // warp-uniform: the role branches are then not divergent
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NWG) {
    // ---------------- producer: one thread issues every TMA load
    if (threadIdx.x == NWG * 128) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int w = 0; w < NWG; ++w)
        tma_load_4d(base + w * C::Q_PANEL, &tm_q, bar_q, 0, q0 + 64 * w, h,
                    b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        const int kt0 = col_idx[e_begin + t / tiles_a_block] * block +
                        (t % tiles_a_block) * BK;
        if (t >= STAGES) mbar_wait(bar_empty + 8 * s, (t / STAGES - 1) & 1);
        const uint32_t kb = base + C::Q_BYTES + s * 2 * C::KV_BYTES;
        mbar_expect_tx(bar_full_k + 8 * s, C::KV_BYTES);
        tma_load_4d(kb, &tm_k, bar_full_k + 8 * s, 0, kt0, h, b);
        mbar_expect_tx(bar_full_v + 8 * s, C::KV_BYTES);
        tma_load_4d(kb + C::KV_BYTES, &tm_v, bar_full_v + 8 * s, 0, kt0, h,
                    b);
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns 64 query rows
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int quad = lane % 4;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
    const uint32_t qa = base + wg * C::Q_PANEL;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % STAGES;
      const uint32_t parity = (t / STAGES) & 1;
      const uint32_t kb = base + C::Q_BYTES + s * 2 * C::KV_BYTES;
      const uint32_t vb = kb + C::KV_BYTES;
      float sc[BK / 2];
      uint32_t p[BK / 16][4];

      mbar_wait(bar_full_k + 8 * s, parity);
      // S = Q . K^T
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        WgmmaSS<BK>::run(sc, desc(qa + 32 * kk, ROWB),
                         desc(kb + 32 * kk, ROWB), kk != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scores in log2 units; every pair of the tile is visible, so the
      // running max is finite from the first tile on
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int hh = (i >> 1) & 1;
        sc[i] *= scale_log2;
        mx[hh] = fmaxf(mx[hh], sc[i]);
      }
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
        mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
        const float m_new = fmaxf(m[hh], mx[hh]);
        alpha[hh] = exp2f(m[hh] - m_new);  // 0 on the first tile
        m[hh] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int hh = (i >> 1) & 1;
        sc[i] = exp2f(sc[i] - m[hh]);
        rs[hh] += sc[i];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + rs[hh];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      // p rounded to bf16: the accumulator's 16 columns of slice kk are
      // the A fragment of the P.V wgmma for keys 16 kk .. 16 kk + 15
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

      mbar_wait(bar_full_v + 8 * s, parity);
      // O += P . V
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(p[kk]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        WgmmaRS<D>::run(acc, p[kk], desc(vb + 16 * ROWB * kk, ROWB));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) fence_regs(p[kk]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);  // stage s is free
    }

    // epilogue: the row sums across the quad, O = acc / l, lse
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
      l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
      const int row = row0 + 8 * hh;
      const float safe_l = l[hh] == 0.f ? 1.f : l[hh];
      __nv_bfloat16* orow = o + b * o_sb + h * o_sh + row * o_st;
#pragma unroll
      for (int jb = 0; jb < D / 8; ++jb) {
        const int col = 8 * jb + 2 * quad;
        const int i = 4 * jb + 2 * hh;
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(__fdiv_rn(acc[i], safe_l),
                                  __fdiv_rn(acc[i + 1], safe_l));
      }
      if (quad == 0)
        lse[(static_cast<long long>(b) * H + h) * Sq + row] =
            (m[hh] + log2f(safe_l)) * LN2;
    }
  }
}

// st: (batch, head, token) element strides of q, k, v (tensor maps) and O
template <int NWG>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* row_ptr, const int* col_idx, const int* order, int B,
           int H, int Sq, int Sk, int block, const long long* st, float scale,
           cudaStream_t stream) {
  using C = Cfg<NWG>;
  CUtensorMap tm_q, tm_k, tm_v;
  int e = make_bthd_map(&tm_q, q, B, H, Sq, D, st[0], st[1], st[2], D, 64);
  if (!e) e = make_bthd_map(&tm_k, k, B, H, Sk, D, st[3], st[4], st[5], D,
                            C::BK);
  if (!e) e = make_bthd_map(&tm_v, v, B, H, Sk, D, st[6], st[7], st[8], D,
                            C::BK);
  if (e) return TENSOR_MAP_ERROR + e;
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        block_sparse_fwd_sm90_kernel<NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  // one CTA per 64 * NWG query rows of every (batch, head, query block)
  const unsigned grid = static_cast<unsigned>(B) * H * (Sq / (64 * NWG));
  block_sparse_fwd_sm90_kernel<NWG><<<grid, C::THREADS, C::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), lse, row_ptr,
      col_idx, order, B, H, Sq, block, st[9], st[10], st[11],
      scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, O as [B, H, S, 64] views with element strides (batch,
// head, token) and a contiguous last dim; lse contiguous fp32 [B, H, Sq].
// row_ptr [H * nq + 1] and col_idx int32 on the device: query block i of
// head h attends the key blocks col_idx[row_ptr[h * nq + i] .. row_ptr[h *
// nq + i + 1]), none empty; order [H * nq] int32, the pairs h * nq + i
// longest row first. Returns 0 when launched, a cudaError_t code
// (cudaErrorInvalidValue for a head dim other than 64, or a block that is
// not a multiple of 64 dividing Sq and Sk), or 10000 + the CUresult of a
// tensor map that cuTensorMapEncodeTiled refused.
extern "C" int ds_block_sparse_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse,
    const void* row_ptr, const void* col_idx, const void* order, int B,
    int H, int Sq, int Sk, int Dh, int block, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, float scale, void* stream) {
  if (Dh != D || block < 64 || block % 64 || Sq % block || Sk % block)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                            v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ci = static_cast<const int*>(col_idx);
  const int* od = static_cast<const int*>(order);
  // two consumer warpgroups (128 query rows a CTA, 128 keys a tile) where
  // the block holds them
  if (block % 128 == 0)
    return launch<2>(q, k, v, o, l, rp, ci, od, B, H, Sq, Sk, block, st,
                     scale, s);
  return launch<1>(q, k, v, o, l, rp, ci, od, B, H, Sq, Sk, block, st, scale,
                   s);
}
