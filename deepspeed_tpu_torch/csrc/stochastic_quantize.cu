// Per-tensor int8 quantization with stochastic rounding for Hopper (sm_90a).
//
// Replaces the TPU kernel stochastic_quantize_tpu.kernel
// (deepspeed_tpu/ops/quantizer.py:141, launched by pallas_call at :154):
// scale = absmax / 127 (1 where that is 0) over the whole fp32 tensor, and
// q = clip(floor(x / scale + u), -128, 127) with u the top 24 bits of a
// random word times 2^-24. The TPU's PRNG cannot be matched here: u comes
// from Philox4x32-10 keyed by (seed, 0) at counter (i >> 2, 0, 0, 0), word
// i & 3 for element i, so the codes depend on (seed, element index) only
// and equal the plain version's (ops/quantizer.py) bit for bit.
//
// What bounds it on the H100: bytes, then pass 2's instruction rate. The
// function reads 4 B and writes 1 B an element; the scale needs every
// element before the first code, so x is read twice, less what stays on
// chip between the passes. Design: one cooperative launch of one CTA an
// SM (the grid comes from the occupancy API, queried once). x is cut into
// tiles of TILE_QUADS quads (4 elements, one Philox call; 32 KB a tile),
// and CTA c takes tiles c, c + grid, c + 2 grid, ..., so the grid sweeps
// one compact window of x at a time.
//
// Pass 1 walks the CTA's tiles forward with 16-byte loads, the next
// tile's in flight while it reduces the current one, and keeps its last
// SMEM_TILES tiles (x's last ~29.6 MB) in dynamic shared memory (224 KB).
// Each CTA writes its absmax (and its least nonzero |x|) to its own slots
// of a workspace, the grid syncs, and every CTA reduces the slots itself:
// no atomic, no zeroed word, no second launch.
//
// Pass 2 walks the tiles backward: first the ones in shared memory, then
// the rest, which TMA bulk copies bring into the slots as they free up,
// SMEM_TILES tiles ahead (one mbarrier a slot). The codes go out with
// streaming stores (.cs).
//
// The quotient x / scale is the correctly rounded one of IEEE division (as
// the TPU kernel's x / scale): from a two-word reciprocal of the scale
// computed once, one multiply and three FMAs (Markstein's correction).
// Its premises (normal reciprocal, quotients and exact remainders) hold
// for the whole call when the scale is in [2^-126, 2^100] and every
// nonzero |x| is at least 2^-100 max(1, scale), which pass 1's least
// nonzero |x| decides once. Such a call also has |x / scale| <= 127 (1 +
// 2^-23), so floor(x / scale + u) >= -128, and the floor is one
// round-down add of 1.5 2^23, whose low byte is the code: no conversion
// instruction. Any other call divides with __fdiv_rn and converts with
// cvt.rmi. A max that keeps NaN gives a NaN scale (and codes 0) for a NaN
// anywhere, as max|x| does. An input that is not 16-byte aligned (a view
// at an odd offset) takes scalar loads and no TMA, and a ragged last quad
// scalar loads and byte stores.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sm90_common.cuh"

namespace cg = cooperative_groups;
using namespace dsport::sm90;

namespace {

constexpr int THREADS = 512;
constexpr int UNROLL = 4;                      // quads a thread per tile
constexpr int TILE_QUADS = THREADS * UNROLL;   // 32 KB of x
constexpr int SMEM_TILES = 7;
constexpr int SMEM_BYTES = SMEM_TILES * TILE_QUADS * 16;  // 224 KB
constexpr float TINY = 0x1p-100f;

// Philox4x32-10 at counter (c0, c1, 0, 0) under the key (k0, 0), with
// the first key word of each round precomputed (k0 + r 0x9E3779B9; the
// second, r 0xBB67AE85, is a constant of the unrolled round)
__device__ __forceinline__ uint4 philox4x32_10(uint32_t c0, uint32_t c1,
                                               const uint32_t (&k0)[10]) {
  uint32_t c2 = 0, c3 = 0;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0[r];
    c1 = lo1;
    c2 = hi0 ^ c3 ^ (r * 0xBB67AE85u);
    c3 = lo0;
  }
  return make_uint4(c0, c1, c2, c3);
}

// (w >> 8) 2^-24 exactly, without a conversion: the top 23 bits as the
// mantissa of a float in [1, 2), less 1, plus 2^-24 where bit 8 is set
// (both steps exact)
__device__ __forceinline__ float uniform24(uint32_t w) {
  const float f = __uint_as_float(0x3F800000u | (w >> 9)) - 1.f;
  return (w & 0x100u) ? f + 0x1p-24f : f;
}

// one code in the low byte (the upper bytes are not defined):
// floor(x / scale + u) clipped to int8.
// FAST: r = RN(1 / scale) and r_lo = RN((1 - scale r) / scale) hold
// 1 / scale to ~2^-47, so q0 = RN(x r + RN(x r_lo)) lies within an ulp
// of x / scale (RN(x r) alone can miss it by 1.5 ulps); the remainder
// x - q0 scale is then exact (one FMA), and RN(q0 + rem r) is the
// correctly rounded quotient (Markstein). The floor of v in [-128, 127]
// is RD(v + 1.5 2^23) - 1.5 2^23, whose two's complement low byte is the
// float's own. Otherwise: IEEE division, and cvt.rmi, which saturates
// +-inf and turns NaN (a NaN scale) into 0, as the TPU kernel's and the
// plain version's casts do
template <bool FAST>
__device__ __forceinline__ uint32_t code(float x, float scale, float r,
                                         float r_lo, uint32_t word) {
  if (FAST) {
    const float q0 = __fmaf_rn(x, r, __fmul_rn(x, r_lo));
    const float rem = __fmaf_rn(-q0, scale, x);
    const float v = fminf(__fadd_rn(__fmaf_rn(rem, r, q0), uniform24(word)),
                          127.f);
    return __float_as_uint(__fadd_rd(v, 12582912.f));
  }
  const int i =
      __float2int_rd(__fadd_rn(__fdiv_rn(x, scale), uniform24(word)));
  return static_cast<uint32_t>(i < -128 ? -128 : i > 127 ? 127 : i);
}

template <bool FAST>
__device__ __forceinline__ uint32_t quad_codes(float4 v, uint4 w,
                                               float scale, float r,
                                               float r_lo) {
  const uint32_t lo = __byte_perm(code<FAST>(v.x, scale, r, r_lo, w.x),
                                  code<FAST>(v.y, scale, r, r_lo, w.y),
                                  0x0040);
  const uint32_t hi = __byte_perm(code<FAST>(v.z, scale, r, r_lo, w.z),
                                  code<FAST>(v.w, scale, r, r_lo, w.w),
                                  0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// max that keeps a NaN (fmaxf drops it): a NaN anywhere gives a NaN
// absmax and scale, as max|x| does in the TPU kernel and the plain version
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

__device__ __forceinline__ float absmax4(float4 v) {
  return nan_max(nan_max(fabsf(v.x), fabsf(v.y)),
                 nan_max(fabsf(v.z), fabsf(v.w)));
}

// |v|, or inf for 0 (NaN is dropped by fminf: it makes the scale NaN,
// which takes the IEEE path anyway)
__device__ __forceinline__ float nonzero_abs(float v) {
  const float a = fabsf(v);
  return a > 0.f ? a : __int_as_float(0x7F800000);
}

// the least nonzero |x| of a quad (inf for none)
__device__ __forceinline__ float absmin4(float4 v) {
  return fminf(fminf(nonzero_abs(v.x), nonzero_abs(v.y)),
               fminf(nonzero_abs(v.z), nonzero_abs(v.w)));
}

// the CTA's NaN-keeping max of m and min of mn, returned to every thread
__device__ void block_reduce(float& m, float& mn, float* warp_max,
                             float* warp_min) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
  }
  __syncthreads();  // an earlier reduction's readers are done
  if ((threadIdx.x & 31) == 0) {
    warp_max[threadIdx.x >> 5] = m;
    warp_min[threadIdx.x >> 5] = mn;
  }
  __syncthreads();
  m = warp_max[0];
  mn = warp_min[0];
#pragma unroll
  for (int w = 1; w < THREADS / 32; ++w) {
    m = nan_max(m, warp_max[w]);
    mn = fminf(mn, warp_min[w]);
  }
}

// `bytes` (a multiple of 16) from global `src` into shared memory at
// `dst` by TMA, completing on the mbarrier `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// quad k (elements 4k .. 4k+3; those at or past n read as 0)
template <bool VEC>
__device__ __forceinline__ float4 load_quad(const float* __restrict__ x,
                                            long long k, long long n) {
  const long long i = 4 * k;
  if (VEC && i + 4 <= n) return __ldg(reinterpret_cast<const float4*>(x) + k);
  float4 v;
  v.x = __ldg(x + i);
  v.y = i + 1 < n ? __ldg(x + i + 1) : 0.f;
  v.z = i + 2 < n ? __ldg(x + i + 2) : 0.f;
  v.w = i + 3 < n ? __ldg(x + i + 3) : 0.f;
  return v;
}

__device__ __forceinline__ void store_codes(int8_t* __restrict__ q,
                                            long long k, long long n,
                                            uint32_t packed) {
  const long long i = 4 * k;
  if (i + 4 <= n) {  // q comes from torch.empty: 4-byte aligned at 4k
    asm volatile("st.global.cs.u32 [%0], %1;"
                 :: "l"(q + i), "r"(packed) : "memory");
    return;
  }
  for (int e = 0; e < 4 && i + e < n; ++e)
    q[i + e] = static_cast<int8_t>(packed >> (8 * e));
}

// the codes of this thread's quads (base + j THREADS + tid) of the tile
// at quad `base`, from v
template <bool FAST>
__device__ __forceinline__ void tile_codes(const float4 (&v)[UNROLL],
                                           int8_t* __restrict__ q,
                                           long long n, long long nq,
                                           long long base, int tid,
                                           float scale, float r, float r_lo,
                                           const uint32_t (&keys)[10]) {
#pragma unroll
  for (int j = 0; j < UNROLL; ++j) {
    const long long k = base + j * THREADS + tid;
    if (k >= nq) continue;
    const uint4 w = philox4x32_10(static_cast<uint32_t>(k),
                                  static_cast<uint32_t>(k >> 32), keys);
    store_codes(q, k, n, quad_codes<FAST>(v[j], w, scale, r, r_lo));
  }
}

// passes: 1 = absmax and scale, 2 = codes, 3 = both (a call). Pass 2
// alone (for timing) reads the scale a full call wrote, takes the fast
// path wherever the scale allows it, and brings every tile from L2 or
// device memory.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
quantize_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                float* __restrict__ scale_io, float* __restrict__ partial,
                long long n, uint32_t seed, int passes) {
  // the CTA's tile t is x's tile blockIdx.x + t gridDim.x; it lives in
  // slot t % SMEM_TILES of shared memory in both passes
  extern __shared__ __align__(128) float4 slots[];
  __shared__ float warp_max[THREADS / 32], warp_min[THREADS / 32];
  __shared__ __align__(8) uint64_t full[SMEM_TILES];
  const int tid = threadIdx.x;
  const long long nq = (n + 3) / 4;
  const long long full_quads = n / 4;  // TMA moves full quads only
  const long long all_tiles = (nq + TILE_QUADS - 1) / TILE_QUADS;
  const int ntiles = blockIdx.x < all_tiles
      ? static_cast<int>((all_tiles - 1 - blockIdx.x) / gridDim.x + 1) : 0;
  auto tile_base = [&](int t) {
    return (blockIdx.x + static_cast<long long>(t) * gridDim.x) * TILE_QUADS;
  };
  const bool keep = passes & 1;
  const int first_kept = max(ntiles - SMEM_TILES, 0);  // pass 1 keeps these
  if (VEC && tid == 0) {
    for (int s = 0; s < SMEM_TILES; ++s) mbar_init(smem_u32(full + s), 1);
    mbar_fence_init();
  }
  __syncthreads();

  // this thread's quads of tile t from global memory (0 past nq)
  auto load_tile = [&](float4 (&dst)[UNROLL], int t) {
    const long long base = tile_base(t);
#pragma unroll
    for (int j = 0; j < UNROLL; ++j) {
      const long long k = base + j * THREADS + tid;
      dst[j] = k < nq ? load_quad<VEC>(x, k, n)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  float4 v[UNROLL];

  float scale, least;
  if (passes & 1) {
    float m = 0.f, mn = __int_as_float(0x7F800000);
    float4 nxt[UNROLL];
    if (ntiles > 0) load_tile(v, 0);
    for (int t = 0; t < ntiles; ++t) {
      if (t + 1 < ntiles) load_tile(nxt, t + 1);
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        m = nan_max(m, absmax4(v[j]));
        mn = fminf(mn, absmin4(v[j]));
      }
      if (t >= first_kept) {
        float4* slot = slots + (t % SMEM_TILES) * TILE_QUADS;
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) slot[j * THREADS + tid] = v[j];
      }
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) v[j] = nxt[j];
    }
    block_reduce(m, mn, warp_max, warp_min);
    if (tid == 0) {
      partial[blockIdx.x] = m;
      partial[gridDim.x + blockIdx.x] = mn;
    }
    cg::this_grid().sync();
    // every CTA reduces the slots itself; __ldcg reads L2 (the slots were
    // written by other SMs)
    float a = 0.f;
    least = __int_as_float(0x7F800000);
    for (int i = tid; i < static_cast<int>(gridDim.x); i += THREADS) {
      a = nan_max(a, __ldcg(partial + i));
      least = fminf(least, __ldcg(partial + gridDim.x + i));
    }
    block_reduce(a, least, warp_max, warp_min);
    scale = __fdiv_rn(a, 127.f);
    if (scale == 0.f) scale = 1.f;
    if (blockIdx.x == 0 && tid == 0) *scale_io = scale;
  } else {
    scale = __ldcg(scale_io);
    least = __int_as_float(0x7F800000);
  }
  if (!(passes & 2)) return;

  // tile t into its slot by TMA (thread 0)
  auto load_slot = [&](int t) {
    const int s = t % SMEM_TILES;
    const long long base = tile_base(t);
    const long long quads = full_quads - base < TILE_QUADS
                                ? full_quads - base : TILE_QUADS;
    const uint32_t bytes = quads > 0 ? static_cast<uint32_t>(quads) * 16 : 0u;
    const uint32_t bar = smem_u32(full + s);
    mbar_expect_tx(bar, bytes);
    if (bytes)
      bulk_load(smem_u32(slots + s * TILE_QUADS), x + 4 * base, bytes, bar);
  };
  if (VEC && !keep && tid == 0)  // pass 2 alone: the last tiles too
    for (int t = first_kept; t < ntiles; ++t) load_slot(t);

  const float r = __frcp_rn(scale);
  const float r_lo = __fdiv_rn(__fmaf_rn(-scale, r, 1.f), scale);
  // NaN fails every test: a NaN, infinite, subnormal or huge scale, or an
  // element too small for an exact remainder, takes the IEEE path
  const bool fast = scale >= 0x1p-126f && scale <= 0x1p+100f &&
                    least >= TINY * fmaxf(scale, 1.f);
  uint32_t keys[10];  // Philox's first key word, round by round
#pragma unroll
  for (int i = 0; i < 10; ++i) keys[i] = seed + i * 0x9E3779B9u;
  uint32_t phases = 0;  // the parity each slot's mbarrier waits for next
  // backward: the kept tiles first, then each earlier tile into the slot
  // its successor (SMEM_TILES later) frees
  for (int t = ntiles - 1; t >= 0; --t) {
    const int s = t % SMEM_TILES;
    const long long base = tile_base(t);
    if (t >= first_kept && keep) {
      const float4* slot = slots + s * TILE_QUADS;
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) v[j] = slot[j * THREADS + tid];
    } else if (VEC) {
      mbar_wait(smem_u32(full + s), (phases >> s) & 1);
      phases ^= 1u << s;
      const float4* slot = slots + s * TILE_QUADS;
#pragma unroll
      for (int j = 0; j < UNROLL; ++j) {
        const long long k = base + j * THREADS + tid;
        // a ragged last quad never came by TMA
        v[j] = k < full_quads ? slot[j * THREADS + tid]
                              : (k < nq ? load_quad<VEC>(x, k, n)
                                        : make_float4(0.f, 0.f, 0.f, 0.f));
      }
    } else {  // an unaligned x: no TMA
      load_tile(v, t);
    }
    if (fast)
      tile_codes<true>(v, q, n, nq, base, tid, scale, r, r_lo, keys);
    else
      tile_codes<false>(v, q, n, nq, base, tid, scale, r, r_lo, keys);
    if (VEC && t - SMEM_TILES >= 0) {
      __syncthreads();  // every thread has read slot s
      if (tid == 0) {
        fence_proxy_async();  // those reads before TMA's writes
        load_slot(t - SMEM_TILES);
      }
    }
  }
}

}  // namespace

// The cooperative grid: resident CTAs an SM (one, at 224 KB of shared
// memory) times the SMs, for the current device. Sets the kernels'
// shared-memory limit; the caller queries it once a device and passes it
// to every launch. Returns the CUDA error code (0 = success).
extern "C" int ds_stochastic_quantize_grid(int* blocks) {
  int dev = 0, sms = 0, per_sm = 0, per_sm_scalar = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(quantize_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(quantize_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quantize_kernel<true>, THREADS, SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm_scalar, quantize_kernel<false>, THREADS, SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  *blocks = (per_sm < per_sm_scalar ? per_sm : per_sm_scalar) * sms;
  return *blocks > 0 ? 0 : static_cast<int>(cudaErrorInvalidConfiguration);
}

// x: n fp32 (contiguous; 16-byte aligned or not); q: n int8 (4-byte
// aligned); scale: one fp32; partial: 2 `grid` fp32 of workspace, nothing
// to zero. One cooperative launch of `grid` CTAs (from
// ds_stochastic_quantize_grid) on `stream`. Returns the CUDA error code
// of the launch (0 = launched).
extern "C" int ds_stochastic_quantize(const void* x, void* q, void* scale,
                                      void* partial, long long n,
                                      unsigned int seed, int passes, int grid,
                                      void* stream) {
  const float* xf = static_cast<const float*>(x);
  int8_t* qc = static_cast<int8_t*>(q);
  float* sc = static_cast<float*>(scale);
  float* pp = static_cast<float*>(partial);
  uint32_t sd = seed;
  void* args[] = {&xf, &qc, &sc, &pp, &n, &sd, &passes};
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const void* fn = vec ? reinterpret_cast<const void*>(quantize_kernel<true>)
                       : reinterpret_cast<const void*>(quantize_kernel<false>);
  cudaError_t e = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(THREADS), args, SMEM_BYTES,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
