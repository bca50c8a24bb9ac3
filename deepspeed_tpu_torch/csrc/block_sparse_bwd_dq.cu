// Block-sparse attention backward, dQ pass, for Hopper (sm_90a), plain CUDA
// C++.
//
// Replaces the TPU kernel _bwd_dq_kernel of
// deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py (:175, launched by
// _sparse_backward at :280). Over a query block's active key blocks it
// recomputes p = exp(s * scale - lse) from the forward's fp32 logsumexp,
// dp = dO . V^T, ds = p * (dp - delta) * scale rounded to the input dtype (the
// TPU kernel's ds.astype(k.dtype)), and accumulates dQ = ds . K in fp32,
// written once in the input dtype. delta = rowsum(dO * O) comes from the
// caller in fp32, as the TPU wrapper computes it outside the kernels.
//
// What bounds it on the H100: 6*D flops per visible (query, key) pair (s, dp
// and ds . K). At the slice shape (B=2, H=16, S=4096, D=64, block 128, density
// 0.344) that is 7.1e10 flops, 0.072 ms at 989 TF/s, against 85 MB of q, k,
// v, dO, dQ (bf16), lse and delta, 0.025 ms at 3.35 TB/s: the tensor cores
// bound it.
// This first version multiplies on the fp32 CUDA cores from shared memory, so
// shared-memory bandwidth limits it (PERF.md carries its time beside the
// bound).
//
// Design: one block of 2*RQ threads owns RQ query rows of one (batch, head,
// query block) and walks that row's column list (CSR, as the forward), taking
// each column block in 64-key sub-tiles, and keeps dQ in registers: no atomics
// and no second pass. K and V are staged transposed (16-byte reads across keys
// for s and dp) and K also by rows (16-byte reads across the head dim for
// ds . K). A pair of threads owns one query row: each scores 32 keys of the
// sub-tile, and after the pair has written its ds row to shared memory each
// accumulates half of the head dim. RQ = 64 when the block is a multiple of
// 64 (32, 16 otherwise).
//
// Explicit (batch, head, token) element strides for q, k, v, dO and dQ (last
// dim contiguous); lse and delta contiguous [B, H, S] fp32. Head dim 64 only.

#include <cstdint>

#include "attention_common.cuh"

using namespace dsport;

namespace {

constexpr int D = 64;        // head dim
constexpr int BK = 64;       // keys per sub-tile
constexpr int KTS = BK + 4;  // transposed-tile row stride (16-byte rows)

template <int RQ>
constexpr int smem_floats() {
  // Kt, Vt [D][KTS]; Ks [BK][D]; Qs, dOs [RQ][D + 1]; dSs [RQ][BK + 1]
  return 2 * D * KTS + BK * D + 2 * RQ * (D + 1) + RQ * (BK + 1);
}

template <typename T, int RQ>
__global__ void __launch_bounds__(2 * RQ)
block_sparse_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const T* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           T* __restrict__ dq,
                           const int* __restrict__ row_ptr,
                           const int* __restrict__ col_idx, int H, int Sq,
                           int block, const Strides<15> st, float scale) {
  constexpr int THREADS = 2 * RQ;
  constexpr int HALF_D = D / 2;
  constexpr int HALF_K = BK / 2;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][KTS]  K transposed
  float* Vt = Kt + D * KTS;                     // [D][KTS]  V transposed
  float* Ks = Vt + D * KTS;                     // [BK][D]   K by rows
  float* Qs = Ks + BK * D;                      // [RQ][D + 1]
  float* dOs = Qs + RQ * (D + 1);               // [RQ][D + 1]
  float* dSs = dOs + RQ * (D + 1);              // [RQ][BK + 1]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * RQ;
  const int nq = Sq / block;
  const int qblk = q0 / block;
  const int tid = threadIdx.x;
  const int r = tid >> 1;    // this thread's query row within the tile
  const int half = tid & 1;  // which half of the keys / head dim it owns
  const int row_t = q0 + r;

  // strides: q, k, v, dO, dQ, each (batch, head, token)
  const T* qb = q + b * st.v[0] + h * st.v[1];
  const T* kb = k + b * st.v[3] + h * st.v[4];
  const T* vb = v + b * st.v[6] + h * st.v[7];
  const T* ob = dout + b * st.v[9] + h * st.v[10];

  for (int i = tid; i < RQ * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    const long long t = q0 + rr;
    Qs[rr * (D + 1) + d] = to_float(qb[t * st.v[2] + d]);
    dOs[rr * (D + 1) + d] = to_float(ob[t * st.v[11] + d]);
  }
  const float row_lse = lse[(long long)bh * Sq + row_t];
  const float row_delta = delta[(long long)bh * Sq + row_t];

  const int e_begin = row_ptr[h * nq + qblk];
  const int e_end = row_ptr[h * nq + qblk + 1];

  float acc[HALF_D];
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) acc[i] = 0.f;

  for (int e = e_begin; e < e_end; ++e) {
    const int k_begin = col_idx[e] * block;
    const int k_stop = k_begin + block;
    for (int k0 = k_begin; k0 < k_stop; k0 += BK) {
      __syncthreads();  // Q, dO staged; previous sub-tile's reads finished
      for (int i = tid; i < BK * D; i += THREADS) {
        const int rr = i / D, d = i % D;
        const int t = k0 + rr;
        const bool in = t < k_stop;
        const float kv = in ? to_float(kb[(long long)t * st.v[5] + d]) : 0.f;
        Kt[d * KTS + rr] = kv;
        Ks[rr * D + d] = kv;
        Vt[d * KTS + rr] =
            in ? to_float(vb[(long long)t * st.v[8] + d]) : 0.f;
      }
      __syncthreads();

      // s = q . k and dp = dO . v for keys [half*32, half*32 + 32)
      float s[HALF_K], dp[HALF_K];
#pragma unroll
      for (int j = 0; j < HALF_K; ++j) s[j] = dp[j] = 0.f;
      const float* qrow = Qs + r * (D + 1);
      const float* orow = dOs + r * (D + 1);
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        const float qd = qrow[d], od = orow[d];
        const float4* kt4 =
            reinterpret_cast<const float4*>(Kt + d * KTS + half * HALF_K);
        const float4* vt4 =
            reinterpret_cast<const float4*>(Vt + d * KTS + half * HALF_K);
#pragma unroll
        for (int jj = 0; jj < HALF_K / 4; ++jj) {
          const float4 kv = kt4[jj];
          const float4 vv = vt4[jj];
          s[4 * jj + 0] += qd * kv.x;
          s[4 * jj + 1] += qd * kv.y;
          s[4 * jj + 2] += qd * kv.z;
          s[4 * jj + 3] += qd * kv.w;
          dp[4 * jj + 0] += od * vv.x;
          dp[4 * jj + 1] += od * vv.y;
          dp[4 * jj + 2] += od * vv.z;
          dp[4 * jj + 3] += od * vv.w;
        }
      }
      float* dsrow = dSs + r * (BK + 1) + half * HALF_K;
#pragma unroll
      for (int j = 0; j < HALF_K; ++j) {
        const bool in = k0 + half * HALF_K + j < k_stop;
        // keys past the block end contribute exactly 0
        const float p = in ? expf(s[j] * scale - row_lse) : 0.f;
        dsrow[j] = round_to<T>(p * (dp[j] - row_delta) * scale);
      }
      __syncwarp();  // the pair's ds halves are visible to both threads

      const float* dsr = dSs + r * (BK + 1);
      for (int j = 0; j < BK; ++j) {
        const float ds = dsr[j];
        const float4* k4 =
            reinterpret_cast<const float4*>(Ks + j * D + half * HALF_D);
#pragma unroll
        for (int ii = 0; ii < HALF_D / 4; ++ii) {
          const float4 kv = k4[ii];
          acc[4 * ii + 0] += ds * kv.x;
          acc[4 * ii + 1] += ds * kv.y;
          acc[4 * ii + 2] += ds * kv.z;
          acc[4 * ii + 3] += ds * kv.w;
        }
      }
    }
  }

  T* dqrow = dq + b * st.v[12] + h * st.v[13] + (long long)row_t * st.v[14] +
             half * HALF_D;
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) dqrow[i] = from_float<T>(acc[i]);
}

template <typename T, int RQ>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, const int* row_ptr,
           const int* col_idx, int B, int H, int Sq, int block,
           const Strides<15>& st, float scale, cudaStream_t stream) {
  constexpr int smem = smem_floats<RQ>() * sizeof(float);
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        block_sparse_bwd_dq_kernel<T, RQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(Sq / RQ, B * H);
  block_sparse_bwd_dq_kernel<T, RQ><<<grid, 2 * RQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), row_ptr, col_idx, H, Sq, block, st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_rows(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dq, const int* row_ptr, const int* col_idx, int B,
                  int H, int Sq, int block, const Strides<15>& st, float scale,
                  cudaStream_t s) {
  if (block % 64 == 0)
    return launch<T, 64>(q, k, v, dout, lse, delta, dq, row_ptr, col_idx, B,
                         H, Sq, block, st, scale, s);
  if (block % 32 == 0)
    return launch<T, 32>(q, k, v, dout, lse, delta, dq, row_ptr, col_idx, B,
                         H, Sq, block, st, scale, s);
  return launch<T, 16>(q, k, v, dout, lse, delta, dq, row_ptr, col_idx, B, H,
                       Sq, block, st, scale, s);
}

}  // namespace

// strides (elements): a host array of 15 int64, (batch, head, token) for q,
// k, v, dO and dQ in that order. row_ptr / col_idx as ds_block_sparse_fwd.
// Returns the cudaGetLastError() code of the launch (0 = launched);
// cudaErrorInvalidValue for a head dim other than 64 or a block that is not
// a multiple of 16 in [16, 256] dividing Sq and Sk.
extern "C" int ds_block_sparse_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, const void* row_ptr,
                                      const void* col_idx, int is_bf16, int B,
                                      int H, int Sq, int Sk, int Dh,
                                      int block, const void* strides,
                                      float scale, void* stream) {
  if (!sparse_shape_ok(Dh, D, block, Sq, Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides<15> st = load_strides<15>(strides);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ci = static_cast<const int*>(col_idx);
  if (is_bf16)
    return dispatch_rows<__nv_bfloat16>(q, k, v, dout, l, dl, dq, rp, ci, B,
                                        H, Sq, block, st, scale, s);
  return dispatch_rows<float>(q, k, v, dout, l, dl, dq, rp, ci, B, H, Sq,
                              block, st, scale, s);
}
