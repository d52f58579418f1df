// Flash attention forward (online softmax) for Hopper.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py `_flash_fwd_stream_kernel`
// (:125, launched by `_flash_fwd_call` :179), which serving reaches through
// `flash_attention_trainable` in bulk prefill (models/transformer.py:1310).
//
// Computes, for q, k, v of shape (BH, T, D) in f32 or bf16:
//   s   = (round_T(q * round_T(scale))) @ k^T          (f32 accumulation)
//   p   = exp(s - m_running)                           (f32)
//   o   = sum_tiles round_T(p) @ v / l                  (f32 accumulation)
//   lse = m + log(l)                                   (f32, (BH, T, 1))
// with the scale folded into the Q tile and the causal mask as in the
// reference: tiles wholly above the diagonal are never loaded, tiles that
// cross it are masked element-wise, tiles below it skip the mask.
//
// Bound on the H100: at the serving shapes (BH = 6, T <= 128, D = 128) the
// whole call moves < 1 MB and does < 0.1 GFLOP, so neither HBM nor the
// tensor cores bound it: it is latency-bound (few blocks, one pass). The
// design keeps every intermediate (scores, probabilities, running max/sum,
// accumulator) on chip: one block per (head-batch row, 64-row Q tile), K/V
// tiles staged in shared memory, f32 accumulators in registers. The products
// are plain FMA loops; wgmma/TMA tiling is later work.

#include <math.h>

#include "common.cuh"

namespace {

using dl4j::from_f;
using dl4j::round_t;
using dl4j::to_f;

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per KV tile
constexpr int NTHREADS = 256; // 16 x 16 thread grid

template <int D>
constexpr size_t smem_bytes() {
  // Q, K, V tiles (row stride D + 1 keeps column reads conflict-free),
  // the probability tile, and per-row running max / sum / correction
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 3 * BQ);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int t, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LP = BK + 1;
  constexpr int NC = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;
  float* m_s = ps + BQ * LP;
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * t * D;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  // the reference multiplies by the scale cast to the input dtype
  const float scale_t = round_t<T>(scale);

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (q0 + r < t) x = round_t<T>(to_f(q[base + (size_t)(q0 + r) * D + c]) * scale_t);
    qs[r * LD + c] = x;
  }
  if (tid < BQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int q_last = min(q0 + BQ, t) - 1;
  // causal: KV tiles past the Q tile's last row are invisible, never loaded
  const int n_tiles = causal ? q_last / BK + 1 : (t + BK - 1) / BK;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with ks/vs/ps
    for (int i = tid; i < BK * D; i += NTHREADS) {
      const int r = i / D, c = i % D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < t) {
        const size_t off = base + (size_t)(k0 + r) * D + c;
        kx = to_f(k[off]);
        vx = to_f(v[off]);
      }
      ks[r * LD + c] = kx;
      vs[r * LD + c] = vx;
    }
    __syncthreads();

    // scores for rows ty + 16i, columns tx + 16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    // only the ragged edge and diagonal-crossing tiles pay the mask
    const bool masked = (k0 + BK > t) || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        if (masked) {
          const int r = q0 + ty + 16 * i, c = k0 + tx + 16 * j;
          if (c >= t || (causal && c > r)) x = -INFINITY;
        }
        ps[(ty + 16 * i) * LP + tx + 16 * j] = x;
      }
    }
    __syncthreads();

    // online softmax: four consecutive lanes own one row, 16 columns each
    {
      const int r = tid >> 2, part = tid & 3;
      float* prow = ps + r * LP;
      float mx = -INFINITY;
      for (int c = part * 16; c < part * 16 + 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      // a row with nothing visible yet keeps p = 0 (no -inf - -inf)
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
      for (int c = part * 16; c < part * 16 + 16; ++c) {
        const float p = expf(prow[c] - m_use);
        sum += p;
        prow[c] = round_t<T>(p);  // PV operand in the value dtype
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
        l_s[r] = corr * l_s[r] + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = vs[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rl = ty + 16 * i;
    const int r = q0 + rl;
    if (r >= t) continue;
    const float l = fmaxf(l_s[rl], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[base + (size_t)r * D + tx + 16 * c] = from_f<T>(acc[i][c] / l);
    if (tx == 0) lse[(size_t)bh * t + r] = m_s[rl] + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t, float scale, int causal,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = dl4j::allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((t + BQ - 1) / BQ, bh);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      t, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int t, int d, float scale,
                       int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, t, scale, causal, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, t, scale, causal, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, t, scale, causal, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, t, scale, causal, s);
    case 256: return launch<T, 256>(q, k, v, o, lse, bh, t, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: (bh, t, d) contiguous in `dtype`; lse: (bh, t) f32.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int dl4j_flash_attn_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int t, int d, float scale, int causal,
                                   int dtype, void* stream) {
  if (bh <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kF32)
    return (int)dispatch_d<float>(q, k, v, o, lse, bh, t, d, scale, causal, s);
  if (dtype == dl4j::kBF16)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, t, d, scale,
                                          causal, s);
  return (int)cudaErrorInvalidValue;
}
