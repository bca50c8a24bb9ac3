// Block-sparse attention backward, dK/dV pass, for Hopper (sm_90a), plain
// CUDA C++.
//
// Replaces the TPU kernel _bwd_dkv_kernel of
// deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py (:214, launched by
// _sparse_backward at :311, which walks the transposed entry list). Over the
// query blocks that attend a key block it recomputes p = exp(s * scale - lse)
// from the forward's fp32 logsumexp and accumulates in fp32 dV = p^T . dO,
// with p rounded to dO's dtype first (the TPU kernel's p.astype(do.dtype)),
// and dK = ds^T . Q with ds = p * (dp - delta) * scale, dp = dO . V^T, rounded
// to the input dtype (ds.astype(q.dtype)). delta = rowsum(dO * O) comes from
// the caller in fp32.
//
// What bounds it on the H100: 8*D flops per visible (query, key) pair (s, dp,
// p^T . dO and ds^T . Q). At the slice shape (B=2, H=16, S=4096, D=64, block
// 128, density 0.344) that is 9.5e10 flops, 0.096 ms at 989 TF/s, against
// 102 MB of q, k, v, dO, dK, dV (bf16), lse and delta, 0.030 ms at 3.35 TB/s:
// the tensor cores bound it. This first version multiplies on the fp32 CUDA cores
// from shared memory, so shared-memory bandwidth limits it (PERF.md carries
// its time beside the bound).
//
// Design: where the TPU carries fp32 dK and dV tiles in VMEM along the
// column-major entry list, here one block of 2*RK threads owns RK key rows of
// one (batch, head, key block) and walks that column's row list (CSC: col_ptr
// [H*nk + 1], row_idx, global offsets, per head), taking each query block in
// 32-row sub-tiles, and keeps dK and dV in registers: no atomics and no second
// pass. RK = 64 when the block is a multiple of 64 (32, 16 otherwise). Q and
// dO are staged transposed (16-byte reads across queries for s and dp) and by
// rows (16-byte reads across the head dim for the two accumulations). A pair
// of threads owns one key row: each scores 16 queries of the sub-tile, and
// after the pair has written its p and ds rows to shared memory each
// accumulates half of the head dim.
//
// Explicit (batch, head, token) element strides for q, k, v, dO, dK and dV
// (last dim contiguous); lse and delta contiguous [B, H, S] fp32. Head dim 64
// only.

#include <cstdint>

#include "attention_common.cuh"

using namespace dsport;

namespace {

constexpr int D = 64;        // head dim
constexpr int BQ = 32;       // queries per sub-tile
constexpr int QTS = BQ + 4;  // transposed-tile row stride (16-byte rows)

template <int RK>
constexpr int smem_floats() {
  // Qt, dOt [D][QTS]; Qs, dOs [BQ][D]; Ks, Vs [RK][D + 1];
  // Ps, dSs [RK][BQ + 1]; lse, delta [BQ]
  return 2 * D * QTS + 2 * BQ * D + 2 * RK * (D + 1) + 2 * RK * (BQ + 1) +
         2 * BQ;
}

template <typename T, int RK>
__global__ void __launch_bounds__(2 * RK)
block_sparse_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dk, T* __restrict__ dv,
                            const int* __restrict__ col_ptr,
                            const int* __restrict__ row_idx, int H, int Sq,
                            int Sk, int block, const Strides<18> st,
                            float scale) {
  constexpr int THREADS = 2 * RK;
  constexpr int HALF_D = D / 2;
  constexpr int HALF_Q = BQ / 2;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][QTS]  Q transposed
  float* dOt = Qt + D * QTS;                    // [D][QTS]  dO transposed
  float* Qs = dOt + D * QTS;                    // [BQ][D]   Q by rows
  float* dOs = Qs + BQ * D;                     // [BQ][D]   dO by rows
  float* Ks = dOs + BQ * D;                     // [RK][D + 1]
  float* Vs = Ks + RK * (D + 1);                // [RK][D + 1]
  float* Ps = Vs + RK * (D + 1);                // [RK][BQ + 1]
  float* dSs = Ps + RK * (BQ + 1);              // [RK][BQ + 1]
  float* lse_s = dSs + RK * (BQ + 1);           // [BQ]
  float* delta_s = lse_s + BQ;                  // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * RK;
  const int nk = Sk / block;
  const int kblk = k0 / block;
  const int tid = threadIdx.x;
  const int r = tid >> 1;    // this thread's key row within the tile
  const int half = tid & 1;  // which half of the queries / head dim it owns
  const int key_t = k0 + r;

  // strides: q, k, v, dO, dK, dV, each (batch, head, token)
  const T* qb = q + b * st.v[0] + h * st.v[1];
  const T* kb = k + b * st.v[3] + h * st.v[4];
  const T* vb = v + b * st.v[6] + h * st.v[7];
  const T* ob = dout + b * st.v[9] + h * st.v[10];
  const float* lb = lse + (long long)bh * Sq;
  const float* db = delta + (long long)bh * Sq;

  for (int i = tid; i < RK * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    const long long t = k0 + rr;
    Ks[rr * (D + 1) + d] = to_float(kb[t * st.v[5] + d]);
    Vs[rr * (D + 1) + d] = to_float(vb[t * st.v[8] + d]);
  }

  const int e_begin = col_ptr[h * nk + kblk];
  const int e_end = col_ptr[h * nk + kblk + 1];

  float acc_k[HALF_D], acc_v[HALF_D];
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int e = e_begin; e < e_end; ++e) {
    const int q_begin = row_idx[e] * block;
    const int q_stop = q_begin + block;
    for (int q0 = q_begin; q0 < q_stop; q0 += BQ) {
      __syncthreads();  // K, V staged; previous sub-tile's reads finished
      for (int i = tid; i < BQ * D; i += THREADS) {
        const int rr = i / D, d = i % D;
        const int t = q0 + rr;
        const bool in = t < q_stop;
        const float qv = in ? to_float(qb[(long long)t * st.v[2] + d]) : 0.f;
        const float ov = in ? to_float(ob[(long long)t * st.v[11] + d]) : 0.f;
        Qt[d * QTS + rr] = qv;
        Qs[rr * D + d] = qv;
        dOt[d * QTS + rr] = ov;
        dOs[rr * D + d] = ov;
      }
      for (int i = tid; i < BQ; i += THREADS) {
        const int t = q0 + i;
        lse_s[i] = t < q_stop ? lb[t] : 0.f;
        delta_s[i] = t < q_stop ? db[t] : 0.f;
      }
      __syncthreads();

      // s = k . q and dp = v . dO for queries [half*16, half*16 + 16)
      float s[HALF_Q], dp[HALF_Q];
#pragma unroll
      for (int i = 0; i < HALF_Q; ++i) s[i] = dp[i] = 0.f;
      const float* krow = Ks + r * (D + 1);
      const float* vrow = Vs + r * (D + 1);
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        const float kd = krow[d], vd = vrow[d];
        const float4* qt4 =
            reinterpret_cast<const float4*>(Qt + d * QTS + half * HALF_Q);
        const float4* ot4 =
            reinterpret_cast<const float4*>(dOt + d * QTS + half * HALF_Q);
#pragma unroll
        for (int ii = 0; ii < HALF_Q / 4; ++ii) {
          const float4 qv = qt4[ii];
          const float4 ov = ot4[ii];
          s[4 * ii + 0] += kd * qv.x;
          s[4 * ii + 1] += kd * qv.y;
          s[4 * ii + 2] += kd * qv.z;
          s[4 * ii + 3] += kd * qv.w;
          dp[4 * ii + 0] += vd * ov.x;
          dp[4 * ii + 1] += vd * ov.y;
          dp[4 * ii + 2] += vd * ov.z;
          dp[4 * ii + 3] += vd * ov.w;
        }
      }
      float* prow = Ps + r * (BQ + 1) + half * HALF_Q;
      float* dsrow = dSs + r * (BQ + 1) + half * HALF_Q;
#pragma unroll
      for (int i = 0; i < HALF_Q; ++i) {
        const int qi = half * HALF_Q + i;
        // queries past the block end contribute exactly 0
        const float p =
            q0 + qi < q_stop ? expf(s[i] * scale - lse_s[qi]) : 0.f;
        prow[i] = round_to<T>(p);
        dsrow[i] = round_to<T>(p * (dp[i] - delta_s[qi]) * scale);
      }
      __syncwarp();  // the pair's p and ds halves are visible to both threads

      const float* pr = Ps + r * (BQ + 1);
      const float* dsr = dSs + r * (BQ + 1);
      for (int i = 0; i < BQ; ++i) {
        const float p = pr[i], ds = dsr[i];
        const float4* o4 =
            reinterpret_cast<const float4*>(dOs + i * D + half * HALF_D);
        const float4* q4 =
            reinterpret_cast<const float4*>(Qs + i * D + half * HALF_D);
#pragma unroll
        for (int dd = 0; dd < HALF_D / 4; ++dd) {
          const float4 ov = o4[dd];
          const float4 qv = q4[dd];
          acc_v[4 * dd + 0] += p * ov.x;
          acc_v[4 * dd + 1] += p * ov.y;
          acc_v[4 * dd + 2] += p * ov.z;
          acc_v[4 * dd + 3] += p * ov.w;
          acc_k[4 * dd + 0] += ds * qv.x;
          acc_k[4 * dd + 1] += ds * qv.y;
          acc_k[4 * dd + 2] += ds * qv.z;
          acc_k[4 * dd + 3] += ds * qv.w;
        }
      }
    }
  }

  T* dkrow = dk + b * st.v[12] + h * st.v[13] + (long long)key_t * st.v[14] +
             half * HALF_D;
  T* dvrow = dv + b * st.v[15] + h * st.v[16] + (long long)key_t * st.v[17] +
             half * HALF_D;
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) {
    dkrow[i] = from_float<T>(acc_k[i]);
    dvrow[i] = from_float<T>(acc_v[i]);
  }
}

template <typename T, int RK>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv,
           const int* col_ptr, const int* row_idx, int B, int H, int Sq,
           int Sk, int block, const Strides<18>& st, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_floats<RK>() * sizeof(float);
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        block_sparse_bwd_dkv_kernel<T, RK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(Sk / RK, B * H);
  block_sparse_bwd_dkv_kernel<T, RK><<<grid, 2 * RK, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), col_ptr, row_idx, H, Sq, Sk,
      block, st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_rows(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dk, void* dv, const int* col_ptr, const int* row_idx,
                  int B, int H, int Sq, int Sk, int block,
                  const Strides<18>& st, float scale, cudaStream_t s) {
  if (block % 64 == 0)
    return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, col_ptr, row_idx,
                         B, H, Sq, Sk, block, st, scale, s);
  if (block % 32 == 0)
    return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, col_ptr, row_idx,
                         B, H, Sq, Sk, block, st, scale, s);
  return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, col_ptr, row_idx,
                       B, H, Sq, Sk, block, st, scale, s);
}

}  // namespace

// strides (elements): a host array of 18 int64, (batch, head, token) for q,
// k, v, dO, dK and dV in that order. col_ptr [H * Sk/block + 1] and row_idx
// int32 on the device: key block j of head h is attended by the query blocks
// row_idx[col_ptr[h * nk + j] .. col_ptr[h * nk + j + 1]). Returns the
// cudaGetLastError() code of the launch (0 = launched); cudaErrorInvalidValue
// for a head dim other than 64 or a block that is not a multiple of 16 in
// [16, 256] dividing Sq and Sk.
extern "C" int ds_block_sparse_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv,
                                       const void* col_ptr,
                                       const void* row_idx, int is_bf16,
                                       int B, int H, int Sq, int Sk, int Dh,
                                       int block, const void* strides,
                                       float scale, void* stream) {
  if (!sparse_shape_ok(Dh, D, block, Sq, Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides<18> st = load_strides<18>(strides);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int* cp = static_cast<const int*>(col_ptr);
  const int* ri = static_cast<const int*>(row_idx);
  if (is_bf16)
    return dispatch_rows<__nv_bfloat16>(q, k, v, dout, l, dl, dk, dv, cp, ri,
                                        B, H, Sq, Sk, block, st, scale, s);
  return dispatch_rows<float>(q, k, v, dout, l, dl, dk, dv, cp, ri, B, H, Sq,
                              Sk, block, st, scale, s);
}
