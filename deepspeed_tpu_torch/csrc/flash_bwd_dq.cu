// Flash attention backward, dQ pass, for Hopper (sm_90a), plain CUDA C++,
// fp32 (bf16 runs on the tensor cores in flash_bwd_dq_sm90.cu, which would
// round fp32 operands to TF32).
//
// Replaces the TPU kernel _bwd_dq_kernel (deepspeed_tpu/ops/flash_attention.py:196,
// launched by _flash_backward at :336; its [B, T, H, D] twin
// _bwd_dq_kernel_bthd :509 · :591 is this kernel called with strides). For
// one query tile it recomputes p = exp(s * scale - lse) from the forward's
// fp32 logsumexp, dp = dO . V^T, ds = p * (dp - delta) * scale rounded to the
// input dtype (the TPU kernel's ds.astype(k.dtype)), and accumulates
// dQ = ds . K in fp32, written once in the input dtype. delta = rowsum(dO * O)
// comes from the caller (fp32, as the TPU wrapper computes it outside the
// kernel). Bottom-right causal mask (row i sees keys <= i + Tk - Tq); fully
// masked rows (lse = NEG_INF) get p = 0 and dQ = 0.
//
// What bounds it on the H100: the fp32 products, at 67 TF/s outside the
// tensor cores. At the training shape (B=16, H=12, T=1024, D=64, causal)
// the work is ~6*D flops per visible (query, key) pair, ~1.0e8 pairs ->
// 3.9e10 flops, 0.58 ms, against ~253 MB of fp32 inputs and output, 0.076
// ms at 3.35 TB/s. This version multiplies on the CUDA cores from shared
// memory, so shared-memory load bandwidth limits it (PERF.md carries its
// time beside the bound).
// Design: where the TPU carries the fp32 dQ tile in VMEM across a sequential
// key-block grid axis, here one block of 128 threads owns a 64-row query
// tile and loops over 64-key tiles only up to its causal limit, keeping dQ
// in registers, so no atomics and no second pass are needed. K and V are
// staged transposed (16-byte reads across keys for s and dp) and K also by
// rows (16-byte reads across the head dim for ds . K). A pair of threads owns
// one query row: each scores 32 keys of the tile, and after the pair has
// written its ds row to shared memory each accumulates half of the head dim.
//
// Any T (ragged tiles are masked); explicit element strides for q, k, v, dO
// and dQ (last dim contiguous); lse and delta contiguous [B, H, Tq] fp32.
// Head dims 16, 32, 64, 128.

#include <cstdint>

#include "attention_common.cuh"

using namespace dsport;

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // two threads per query row
constexpr int KTS = BK + 4;   // transposed-tile row stride (16-byte rows)

template <int D>
constexpr int smem_floats() {
  // Kt, Vt [D][KTS]; Ks [BK][D]; Qs, dOs [BQ][D + 1]; dSs [BQ][BK + 1]
  return 2 * D * KTS + BK * D + 2 * BQ * (D + 1) + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int Tq, int Tk, const Strides<15> st,
                    float scale, int causal) {
  constexpr int HALF_D = D / 2;
  constexpr int HALF_K = BK / 2;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][KTS]  K transposed
  float* Vt = Kt + D * KTS;                     // [D][KTS]  V transposed
  float* Ks = Vt + D * KTS;                     // [BK][D]   K by rows
  float* Qs = Ks + BK * D;                      // [BQ][D + 1]
  float* dOs = Qs + BQ * (D + 1);               // [BQ][D + 1]
  float* dSs = dOs + BQ * (D + 1);              // [BQ][BK + 1]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 1;    // this thread's query row within the tile
  const int half = tid & 1;  // which half of the keys / head dim it owns
  const int row_t = q0 + r;
  const int off = Tk - Tq;   // bottom-right causal alignment

  // strides: q, k, v, dO, dQ, each (batch, head, token)
  const T* qb = q + b * st.v[0] + h * st.v[1];
  const T* kb = k + b * st.v[3] + h * st.v[4];
  const T* vb = v + b * st.v[6] + h * st.v[7];
  const T* ob = dout + b * st.v[9] + h * st.v[10];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    const int t = q0 + rr;
    const bool in = t < Tq;
    Qs[rr * (D + 1) + d] = in ? to_float(qb[t * st.v[2] + d]) : 0.f;
    dOs[rr * (D + 1) + d] = in ? to_float(ob[t * st.v[11] + d]) : 0.f;
  }
  const bool row_in = row_t < Tq;
  const float row_lse = row_in ? lse[(long long)bh * Tq + row_t] : 0.f;
  const float row_delta = row_in ? delta[(long long)bh * Tq + row_t] : 0.f;

  // keys the tile's last row can see: the causal limit of the loop
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + off + 1) : Tk;

  float acc[HALF_D];
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q, dO staged; previous tile's reads finished
    for (int i = tid; i < BK * D; i += THREADS) {
      const int rr = i / D, d = i % D;
      const int t = k0 + rr;
      const bool in = t < Tk;
      const float kv = in ? to_float(kb[t * st.v[5] + d]) : 0.f;
      Kt[d * KTS + rr] = kv;
      Ks[rr * D + d] = kv;
      Vt[d * KTS + rr] = in ? to_float(vb[t * st.v[8] + d]) : 0.f;
    }
    __syncthreads();

    // s = q . k and dp = dO . v for keys [half*32, half*32 + 32) of the tile
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
      const int kt = k0 + half * HALF_K + j;
      const bool visible =
          row_in && kt < Tk && (!causal || kt <= row_t + off);
      // masked keys contribute exactly 0, also in fully masked rows
      const float p = visible ? expf(s[j] * scale - row_lse) : 0.f;
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

  if (row_in) {
    T* dqrow = dq + b * st.v[12] + h * st.v[13] + row_t * st.v[14] +
               half * HALF_D;
#pragma unroll
    for (int i = 0; i < HALF_D; ++i) dqrow[i] = from_float<T>(acc[i]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, int B, int H,
           int Tq, int Tk, const Strides<15>& st, float scale, int causal,
           cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * sizeof(float);
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, Tq, Tk, st, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dq, int B, int H,
               int Tq, int Tk, int D, const Strides<15>& st, float scale,
               int causal, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, st, scale, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// strides (elements): a host array of 15 int64, (batch, head, token) for
// q, k, v, dO and dQ in that order, passed to the kernel by value. Returns the
// cudaGetLastError() code of the launch (0 = launched).
extern "C" int ds_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* dq, int B, int H,
                               int Tq, int Tk, int D,
                               const void* strides, float scale, int causal,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides<15> st = load_strides<15>(strides);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  return dispatch_d<float>(q, k, v, dout, l, dl, dq, B, H, Tq, Tk, D, st,
                           scale, causal, s);
}
