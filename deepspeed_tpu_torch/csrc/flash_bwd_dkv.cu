// Flash attention backward, dK/dV pass, for Hopper (sm_90a), plain CUDA
// C++, fp32 (bf16 runs on the tensor cores in flash_bwd_dkv_sm90.cu, which
// would round fp32 operands to TF32).
//
// Replaces the TPU kernel _bwd_dkv_kernel (deepspeed_tpu/ops/flash_attention.py:252,
// launched by _flash_backward at :355; its [B, T, H, D] twin
// _bwd_dkv_kernel_bthd :516 · :615 is this kernel called with strides). For
// one key tile it walks the query tiles that can see it, recomputes
// p = exp(s * scale - lse) from the forward's fp32 logsumexp, and accumulates
// in fp32 dV = p^T . dO, with p rounded to dO's dtype first (the TPU kernel's
// p.astype(do.dtype)), and dK = ds^T . Q with ds = p * (dp - delta) * scale,
// dp = dO . V^T, rounded to the input dtype (ds.astype(q.dtype)). delta =
// rowsum(dO * O) comes from the caller in fp32. Bottom-right causal mask (key
// j is seen by rows i with j <= i + Tk - Tq); fully masked rows (lse =
// NEG_INF) contribute nothing; a key no row sees gets dK = dV = 0.
//
// What bounds it on the H100: the fp32 products, at 67 TF/s outside the
// tensor cores. At the training shape (B=16, H=12, T=1024, D=64, causal)
// the work is ~8*D flops per visible (query, key) pair, ~1.0e8 pairs ->
// 5.2e10 flops, 0.78 ms, against ~304 MB of fp32 inputs and outputs,
// 0.091 ms at 3.35 TB/s. This version multiplies on the CUDA cores from
// shared memory, so shared-memory load bandwidth limits it (PERF.md carries
// its time beside the bound).
// Design: where the TPU carries fp32 dK and dV tiles in VMEM across a
// sequential query-block grid axis, here one block of 128 threads owns a
// 64-key tile and loops over 32-row query tiles from the first row that can
// see the tile (causal) to the end, keeping dK and dV in registers, so no
// atomics and no second pass are needed. Q and dO are staged transposed
// (16-byte reads across queries for s and dp) and by rows (16-byte reads
// across the head dim for the two accumulations). A pair of threads owns one
// key row: each scores 16 queries of the tile, and after the pair has written
// its p and ds rows to shared memory each accumulates half of the head dim.
//
// Any T (ragged tiles are masked); explicit element strides for q, k, v, dO,
// dK and dV (last dim contiguous); lse and delta contiguous [B, H, Tq] fp32.
// Head dims 16, 32, 64, 128.

#include <cstdint>

#include "attention_common.cuh"

using namespace dsport;

namespace {

constexpr int BK = 64;        // key rows per block
constexpr int BQ = 32;        // queries per tile
constexpr int THREADS = 128;  // two threads per key row
constexpr int QTS = BQ + 4;   // transposed-tile row stride (16-byte rows)

template <int D>
constexpr int smem_floats() {
  // Qt, dOt [D][QTS]; Qs, dOs [BQ][D]; Ks, Vs [BK][D + 1];
  // Ps, dSs [BK][BQ + 1]; lse, delta [BQ]
  return 2 * D * QTS + 2 * BQ * D + 2 * BK * (D + 1) + 2 * BK * (BQ + 1) +
         2 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Tq, int Tk,
                     const Strides<18> st, float scale, int causal) {
  constexpr int HALF_D = D / 2;
  constexpr int HALF_Q = BQ / 2;
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [D][QTS]  Q transposed
  float* dOt = Qt + D * QTS;                    // [D][QTS]  dO transposed
  float* Qs = dOt + D * QTS;                    // [BQ][D]   Q by rows
  float* dOs = Qs + BQ * D;                     // [BQ][D]   dO by rows
  float* Ks = dOs + BQ * D;                     // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);                // [BK][D + 1]
  float* Ps = Vs + BK * (D + 1);                // [BK][BQ + 1]
  float* dSs = Ps + BK * (BQ + 1);              // [BK][BQ + 1]
  float* lse_s = dSs + BK * (BQ + 1);           // [BQ]
  float* delta_s = lse_s + BQ;                  // [BQ]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int r = tid >> 1;    // this thread's key row within the tile
  const int half = tid & 1;  // which half of the queries / head dim it owns
  const int key_t = k0 + r;
  const int off = Tk - Tq;   // bottom-right causal alignment

  // strides: q, k, v, dO, dK, dV, each (batch, head, token)
  const T* qb = q + b * st.v[0] + h * st.v[1];
  const T* kb = k + b * st.v[3] + h * st.v[4];
  const T* vb = v + b * st.v[6] + h * st.v[7];
  const T* ob = dout + b * st.v[9] + h * st.v[10];
  const float* lb = lse + (long long)bh * Tq;
  const float* db = delta + (long long)bh * Tq;

  for (int i = tid; i < BK * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    const int t = k0 + rr;
    const bool in = t < Tk;
    Ks[rr * (D + 1) + d] = in ? to_float(kb[t * st.v[5] + d]) : 0.f;
    Vs[rr * (D + 1) + d] = in ? to_float(vb[t * st.v[8] + d]) : 0.f;
  }

  // the first query row that sees the tile's first key: the causal start
  const int q_begin = causal ? max(0, k0 - off) : 0;

  float acc_k[HALF_D], acc_v[HALF_D];
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int q0 = (q_begin / BQ) * BQ; q0 < Tq; q0 += BQ) {
    __syncthreads();  // K, V staged; previous tile's reads finished
    for (int i = tid; i < BQ * D; i += THREADS) {
      const int rr = i / D, d = i % D;
      const int t = q0 + rr;
      const bool in = t < Tq;
      const float qv = in ? to_float(qb[t * st.v[2] + d]) : 0.f;
      const float ov = in ? to_float(ob[t * st.v[11] + d]) : 0.f;
      Qt[d * QTS + rr] = qv;
      Qs[rr * D + d] = qv;
      dOt[d * QTS + rr] = ov;
      dOs[rr * D + d] = ov;
    }
    for (int i = tid; i < BQ; i += THREADS) {
      const int t = q0 + i;
      lse_s[i] = t < Tq ? lb[t] : 0.f;
      delta_s[i] = t < Tq ? db[t] : 0.f;
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
      const int qt = q0 + qi;
      const bool visible =
          key_t < Tk && qt < Tq && (!causal || key_t <= qt + off);
      // masked pairs contribute exactly 0, also in fully masked rows
      const float p = visible ? expf(s[i] * scale - lse_s[qi]) : 0.f;
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

  if (key_t < Tk) {
    T* dkrow = dk + b * st.v[12] + h * st.v[13] + key_t * st.v[14] +
               half * HALF_D;
    T* dvrow = dv + b * st.v[15] + h * st.v[16] + key_t * st.v[17] +
               half * HALF_D;
#pragma unroll
    for (int i = 0; i < HALF_D; ++i) {
      dkrow[i] = from_float<T>(acc_k[i]);
      dvrow[i] = from_float<T>(acc_v[i]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dk, void* dv, int B,
           int H, int Tq, int Tk, const Strides<18>& st, float scale,
           int causal, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * sizeof(float);
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dkv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((Tk + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tq, Tk, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int Tq, int Tk, int D, const Strides<18>& st,
               float scale, int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, st, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides (elements): a host array of 18 int64, (batch, head, token) for
// q, k, v, dO, dK and dV in that order, passed to the kernel by value.
// Returns the cudaGetLastError() code of the launch (0 = launched).
extern "C" int ds_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dk, void* dv,
                                int B, int H, int Tq, int Tk, int D,
                                const void* strides, float scale,
                                int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides<18> st = load_strides<18>(strides);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return dispatch_d<float>(q, k, v, dout, l, dl, dk, dv, B, H, Tq, Tk, D, st,
                           scale, causal, s);
}
