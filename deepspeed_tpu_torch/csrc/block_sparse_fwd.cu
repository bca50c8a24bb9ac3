// Block-sparse attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel _fwd_kernel of
// deepspeed_tpu/ops/sparse_attention/block_sparse_kernel.py (:79, launched by
// _sparse_forward_impl at :141): attention restricted to a per-head block
// layout [H, nq, nk] with square blocks. s = q . k^T * scale in fp32, an
// online max m and sum l in fp32, p rounded to V's dtype before P . V (the TPU
// kernel's p.astype(v.dtype)) while l sums the unrounded p, an fp32
// accumulator, O = acc / l written once in the input dtype (l == 0 divides
// by 1, the TPU kernel's guard) and lse = m + log(l) in fp32, [B, H, S].
//
// What bounds it on the H100: 4*D flops per visible (query, key) pair. At the
// slice shape (B=2, H=16, S=4096, D=64, block 128, density 0.344) that is
// 1.85e8 pairs -> 4.7e10 flops, 0.048 ms at 989 TF/s, against 68 MB of q, k,
// v, O (bf16) and lse, 0.020 ms at 3.35 TB/s: the tensor cores bound it. This
// first version multiplies on the fp32 CUDA cores from shared memory, as the
// port's flash kernels do, so shared-memory bandwidth limits it (PERF.md
// carries its time beside the bound); wgmma/TMA tiles are the follow-up.
//
// Design: where the TPU grid walks a flattened, padded entry list and carries
// m, l and acc in VMEM from one entry to the next, here one block of 2*RQ
// threads owns RQ query rows of one (batch, head, query block) and walks that
// row's column list (CSR: row_ptr [H*nq + 1], col_idx, global offsets, per
// head), keeping m, l and acc in registers, so nothing carries between
// blocks. RQ = 64 when the block is a multiple of 64 (32, 16 otherwise), so a
// block of threads never straddles two query blocks. Each column block is
// taken in 64-key sub-tiles (keys past the block end are masked), so any
// block that is a multiple of 16 from 16 to 256 works. K is staged transposed
// and V by rows in shared memory as fp32; a pair of threads owns one query
// row: each scores 32 keys of the sub-tile, the pair exchanges its row max
// and sum with one shuffle, and each accumulates half of the head dim.
//
// Inputs are read through explicit (batch, head, token) element strides with
// the last dim contiguous, so [B, T, H, D] projections go in as transposed
// views without a copy. Head dim 64 only.

#include <cstdint>

#include "attention_common.cuh"

using namespace dsport;

namespace {

constexpr int D = 64;        // head dim
constexpr int BK = 64;       // keys per sub-tile
constexpr int KTS = BK + 4;  // K^T row stride: 16-byte rows, fewer conflicts

template <int RQ>
constexpr int smem_floats() {
  return D * KTS + BK * D + RQ * (D + 1) + RQ * (BK + 1);
}

template <typename T, int RQ>
__global__ void __launch_bounds__(2 * RQ)
block_sparse_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse,
                        const int* __restrict__ row_ptr,
                        const int* __restrict__ col_idx, int H, int Sq,
                        int block, const Strides<12> st, float scale) {
  constexpr int THREADS = 2 * RQ;
  constexpr int HALF_D = D / 2;
  constexpr int HALF_K = BK / 2;
  extern __shared__ float4 smem4[];
  float* Kt = reinterpret_cast<float*>(smem4);  // [D][KTS]  K transposed
  float* Vs = Kt + D * KTS;                     // [BK][D]
  float* Qs = Vs + BK * D;                      // [RQ][D + 1]
  float* Ps = Qs + RQ * (D + 1);                // [RQ][BK + 1]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * RQ;
  const int nq = Sq / block;
  const int qblk = q0 / block;
  const int tid = threadIdx.x;
  const int r = tid >> 1;    // this thread's query row within the tile
  const int half = tid & 1;  // which half of the keys / head dim it owns
  const int row_t = q0 + r;

  // strides: q, k, v, o, each (batch, head, token)
  const T* qb = q + b * st.v[0] + h * st.v[1];
  const T* kb = k + b * st.v[3] + h * st.v[4];
  const T* vb = v + b * st.v[6] + h * st.v[7];

  for (int i = tid; i < RQ * D; i += THREADS) {
    const int rr = i / D, d = i % D;
    Qs[rr * (D + 1) + d] = to_float(qb[(long long)(q0 + rr) * st.v[2] + d]);
  }

  const int e_begin = row_ptr[h * nq + qblk];
  const int e_end = row_ptr[h * nq + qblk + 1];

  float m = NEG_INF, l = 0.f;
  float acc[HALF_D];
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) acc[i] = 0.f;

  for (int e = e_begin; e < e_end; ++e) {
    const int k_begin = col_idx[e] * block;
    const int k_stop = k_begin + block;
    for (int k0 = k_begin; k0 < k_stop; k0 += BK) {
      __syncthreads();  // Q staged; previous sub-tile's K, V, P reads done
      for (int i = tid; i < BK * D; i += THREADS) {
        const int rr = i / D, d = i % D;
        const int t = k0 + rr;
        const bool in = t < k_stop;
        Kt[d * KTS + rr] = in ? to_float(kb[(long long)t * st.v[5] + d]) : 0.f;
        Vs[rr * D + d] = in ? to_float(vb[(long long)t * st.v[8] + d]) : 0.f;
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
        const bool in = k0 + half * HALF_K + j < k_stop;
        s[j] = in ? s[j] * scale : NEG_INF;
        m_tile = fmaxf(m_tile, s[j]);
      }
      m_tile = fmaxf(m_tile, __shfl_xor_sync(0xffffffffu, m_tile, 1));
      const float m_new = fmaxf(m, m_tile);
      const float alpha = expf(m - m_new);
      float p_sum = 0.f;
      float* prow = Ps + r * (BK + 1) + half * HALF_K;
#pragma unroll
      for (int j = 0; j < HALF_K; ++j) {
        // keys past the block end contribute exactly 0
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
  }

  const float safe_l = l == 0.f ? 1.f : l;
  T* orow = o + b * st.v[9] + h * st.v[10] + (long long)row_t * st.v[11] +
            half * HALF_D;
#pragma unroll
  for (int i = 0; i < HALF_D; ++i) orow[i] = from_float<T>(acc[i] / safe_l);
  if (half == 0) lse[(long long)bh * Sq + row_t] = m + logf(safe_l);
}

template <typename T, int RQ>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           const int* row_ptr, const int* col_idx, int B, int H, int Sq,
           int block, const Strides<12>& st, float scale,
           cudaStream_t stream) {
  constexpr int smem = smem_floats<RQ>() * sizeof(float);
  static bool configured = false;  // the >48 KB opt-in, once per instance
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        block_sparse_fwd_kernel<T, RQ>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const dim3 grid(Sq / RQ, B * H);
  block_sparse_fwd_kernel<T, RQ><<<grid, 2 * RQ, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, row_ptr, col_idx, H,
      Sq, block, st, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_rows(const void* q, const void* k, const void* v, void* o,
                  float* lse, const int* row_ptr, const int* col_idx, int B,
                  int H, int Sq, int block, const Strides<12>& st, float scale,
                  cudaStream_t s) {
  if (block % 64 == 0)
    return launch<T, 64>(q, k, v, o, lse, row_ptr, col_idx, B, H, Sq, block,
                         st, scale, s);
  if (block % 32 == 0)
    return launch<T, 32>(q, k, v, o, lse, row_ptr, col_idx, B, H, Sq, block,
                         st, scale, s);
  return launch<T, 16>(q, k, v, o, lse, row_ptr, col_idx, B, H, Sq, block, st,
                       scale, s);
}

}  // namespace

// strides (elements): a host array of 12 int64, (batch, head, token) for q,
// k, v and O in that order. row_ptr [H * Sq/block + 1] and col_idx int32 on
// the device: head h, query block i attends the key blocks
// col_idx[row_ptr[h * nq + i] .. row_ptr[h * nq + i + 1]). Returns the
// cudaGetLastError() code of the launch (0 = launched); cudaErrorInvalidValue
// for a head dim other than 64 or a block that is not a multiple of 16 in
// [16, 256] dividing Sq and Sk.
extern "C" int ds_block_sparse_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   const void* row_ptr, const void* col_idx,
                                   int is_bf16, int B, int H, int Sq, int Sk,
                                   int Dh, int block, const void* strides,
                                   float scale, void* stream) {
  if (!sparse_shape_ok(Dh, D, block, Sq, Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides<12> st = load_strides<12>(strides);
  float* l = static_cast<float*>(lse);
  const int* rp = static_cast<const int*>(row_ptr);
  const int* ci = static_cast<const int*>(col_idx);
  if (is_bf16)
    return dispatch_rows<__nv_bfloat16>(q, k, v, o, l, rp, ci, B, H, Sq, block,
                                        st, scale, s);
  return dispatch_rows<float>(q, k, v, o, l, rp, ci, B, H, Sq, block, st,
                              scale, s);
}
