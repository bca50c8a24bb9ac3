// Flash attention forward for Hopper (sm_90a), plain CUDA C++, fp32.
//
// Replaces the TPU kernel _fwd_kernel (deepspeed_tpu/ops/flash_attention.py:77,
// launched by _flash_forward at :174) for fp32 inputs; bf16 runs on the
// tensor cores in flash_fwd_sm90.cu, which would round fp32 operands to
// TF32. Causal online-softmax attention with the bottom-right mask (row i
// sees keys <= i + Tk - Tq), fp32 running max m, sum l and accumulator, O
// written in the input dtype and lse = m + log(l) in fp32. Fully masked
// rows (Tk < Tq) get p = 0 and O = 0, and l == 0 divides safely, as the
// TPU kernel does.
//
// What bounds it on the H100: the fp32 products, at 67 TF/s outside the
// tensor cores (GPT-2's training shape: 0.385 ms). This version does them
// on the CUDA cores from shared memory, so shared-memory load bandwidth
// limits it (PERF.md carries its time beside the bound). Design: one block
// of 128 threads per (batch*head, 64-row query tile); it loops over 64-key
// tiles up to the causal limit only, staging K transposed and V in shared
// memory so the inner loops read 16-byte vectors. A pair of threads owns
// one query row: each scores 32 keys of the tile, the pair exchanges its
// row max and sum with one shuffle, and each accumulates half of the head
// dim.
//
// Takes any T (ragged tiles are masked) and explicit strides for q, k, v, o
// (last dim contiguous), so the [B, T, H, D] layout (TPU kernel 4) can reuse
// it. Head dims 16, 32, 64, 128.

#include <cstdint>

#include "attention_common.cuh"

using namespace dsport;

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int THREADS = 128; // two threads per query row
constexpr int KTS = BK + 4;  // K^T row stride: 16-byte rows, fewer conflicts

template <int D>
constexpr int smem_floats() {
  return D * KTS + BK * D + BQ * (D + 1) + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 long long q_sb, long long q_sh, long long q_st,
                 long long k_sb, long long k_sh, long long k_st,
                 long long v_sb, long long v_sh, long long v_st,
                 long long o_sb, long long o_sh, long long o_st,
                 float scale, int causal) {
  constexpr int HALF_D = D / 2;
  constexpr int HALF_K = BK / 2;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][KTS]  K transposed
  float* Vs = Kt + D * KTS;                     // [BK][D]
  float* Qs = Vs + BK * D;                      // [BQ][D + 1]
  float* Ps = Qs + BQ * (D + 1);                // [BQ][BK + 1]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid >> 1;    // this thread's query row within the tile
  const int half = tid & 1;  // which half of the keys / head dim it owns
  const int row_t = q0 + r;
  const int off = Tk - Tq;   // bottom-right causal alignment

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    const int t = q0 + rr;
    Qs[rr * (D + 1) + d] = t < Tq ? to_float(qb[t * q_st + d]) : 0.f;
  }

  // keys the tile's last row can see: the causal limit of the loop
  const int q_last = min(q0 + BQ, Tq) - 1;
  const int k_end = causal ? min(Tk, q_last + off + 1) : Tk;

  float m = NEG_INF, l = 0.f;
  float acc[HALF_D];
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // Q staged; previous tile's K, V, P reads finished
    for (int i = tid; i < BK * D; i += THREADS) {
      const int rr = i / D, d = i % D;
      const int t = k0 + rr;
      const bool in = t < Tk;
      Kt[d * KTS + rr] = in ? to_float(kb[t * k_st + d]) : 0.f;
      Vs[rr * D + d] = in ? to_float(vb[t * v_st + d]) : 0.f;
    }
    __syncthreads();

    // scores of this row against keys [half*32, half*32 + 32) of the tile
    float s[HALF_K];
#pragma unroll
    for (int j = 0; j < HALF_K; ++j) s[j] = 0.f;
    const float* qrow = Qs + r * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
      const float4* kt4 =
          reinterpret_cast<const float4*>(Kt + d * KTS + half * HALF_K);
#pragma unroll
      for (int jj = 0; jj < HALF_K / 4; ++jj) {
        const float4 kv = kt4[jj];
        s[4 * jj + 0] += qd * kv.x;
        s[4 * jj + 1] += qd * kv.y;
        s[4 * jj + 2] += qd * kv.z;
        s[4 * jj + 3] += qd * kv.w;
      }
    }
    float m_tile = NEG_INF;
#pragma unroll
    for (int j = 0; j < HALF_K; ++j) {
      const int kt = k0 + half * HALF_K + j;
      const bool visible = kt < Tk && (!causal || kt <= row_t + off);
      s[j] = visible ? s[j] * scale : NEG_INF;
      m_tile = fmaxf(m_tile, s[j]);
    }
    m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
    float* prow = Ps + r * (BK + 1) + half * HALF_K;
#pragma unroll
    for (int j = 0; j < HALF_K; ++j) {
      // masked keys contribute exactly 0, also in fully masked rows
      const float p = s[j] > 0.5f * NEG_INF ? expf(s[j] - m_new) : 0.f;
      p_sum += p;
      prow[j] = round_to<T>(p);
    }
    p_sum += __shfl_xor_sync(0xffffffffu, p_sum, 1);
    l = alpha * l + p_sum;
    m = m_new;
    __syncwarp();  // the pair's P halves are visible to both threads

#pragma unroll
    for (int i = 0; i < HALF_D; ++i) acc[i] *= alpha;
    const float* pr = Ps + r * (BK + 1);
    for (int j = 0; j < BK; ++j) {
      const float p = pr[j];
      const float4* v4 =
          reinterpret_cast<const float4*>(Vs + j * D + half * HALF_D);
#pragma unroll
      for (int ii = 0; ii < HALF_D / 4; ++ii) {
        const float4 vv = v4[ii];
        acc[4 * ii + 0] += p * vv.x;
        acc[4 * ii + 1] += p * vv.y;
        acc[4 * ii + 2] += p * vv.z;
        acc[4 * ii + 3] += p * vv.w;
      }
    }
  }

  if (row_t < Tq) {
    const float safe_l = l == 0.f ? 1.f : l;
    T* orow = o + b * o_sb + h * o_sh + row_t * o_st + half * HALF_D;
#pragma unroll
    for (int i = 0; i < HALF_D; ++i) orow[i] = from_float<T>(acc[i] / safe_l);
    if (half == 0) lse[(long long)bh * Tq + row_t] = m + logf(safe_l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Tq, int Tk, const long long* st, float scale,
           int causal, cudaStream_t stream) {
  constexpr int smem = smem_floats<D>() * sizeof(float);
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, Tq, Tk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Tq, int Tk, int D,
               const long long* st, float scale, int causal,
               cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, B, H, Tq, Tk, st, scale, causal, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// fp32 q, k, v, o; returns the cudaGetLastError() code of the launch (0 =
// launched).
extern "C" int ds_flash_fwd(const void* q, const void* k, const void* v,
                            void* o, void* lse, int B, int H, int Tq, int Tk,
                            int D, long long q_sb, long long q_sh,
                            long long q_st, long long k_sb, long long k_sh,
                            long long k_st, long long v_sb, long long v_sh,
                            long long v_st, long long o_sb, long long o_sh,
                            long long o_st, float scale, int causal,
                            void* stream) {
  const long long st[12] = {q_sb, q_sh, q_st, k_sb, k_sh, k_st,
                            v_sb, v_sh, v_st, o_sb, o_sh, o_st};
  return dispatch_d<float>(q, k, v, o, static_cast<float*>(lse), B, H, Tq,
                           Tk, D, st, scale, causal,
                           static_cast<cudaStream_t>(stream));
}
