// Flash decode attention (one query position per row) for Hopper.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py `_flash_decode_kernel`
// (:502, launched by `flash_decode_attention` :645) in its bf16/f32 mode,
// called from `block_decode` (models/transformer.py:1066) in every decode
// substep of every layer.
//
// Inputs: q (B, G, Hkv*K) — the G query heads of each KV head's group,
// packed head-major; the WHOLE stacked cache (n_layers, 2, B, T, Hkv*K)
// (plane 0 = K, plane 1 = V); pos (B,) int32. Layer `layer`'s planes are
// read in place through strides, never sliced into a copy. For each row b
// and head h:
//   s_t = <q_g, k_t> * scale                   (f32 accumulation), t <= pos[b]
//   o_g = sum_t round_T(exp(s_t - m)) v_t / l  (online softmax, f32)
// Rows past pos[b] contribute nothing and tiles past it are never read.
//
// Bound on the H100: bytes. Each call must read the visible K and V rows of
// one layer, sum_b (pos[b] + 1) * Hkv*K * 2 planes * sizeof(T), and does
// ~4 flops per element read, far below the ~295 flop/byte the card needs
// before compute matters. The design streams every visible cache row exactly
// once per (row, KV head) block: one warp per cache row reads that head's K
// segment coalesced and serves all G query rows of the group from it (the
// counterpart of the reference's GQA fold); the V tile is read coalesced by
// threads over the head dim. Softmax state and accumulators stay in shared
// memory / registers in f32.
//
// Known limit: the grid is (Hkv, B) — 48 blocks for 8 slots x 6 heads on a
// 132-SM card — so a single call cannot reach the memory roofline. Splitting
// T across blocks (flash-decoding) is the first redesign item.

#include <math.h>

#include "common.cuh"

namespace {

using dl4j::from_f;
using dl4j::round_t;
using dl4j::to_f;

constexpr int DT = 64;        // cache rows per tile
constexpr int NTHREADS = 128; // four warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXKD = 256;    // head_dim limit (8 elements per lane)
constexpr int GCHUNK = 8;     // query groups accumulated in registers at once

inline size_t smem_bytes(int g, int kd) {
  // q and accumulator (G x kd each), score tile (G x DT), m / l / corr
  return sizeof(float) * ((size_t)2 * g * kd + (size_t)g * DT + 3 * (size_t)g);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ cache,
                        const int* __restrict__ pos, T* __restrict__ out,
                        int B, int G, int hkv, int kd, int t, int layer,
                        float scale) {
  extern __shared__ float sm[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = hkv * kd;
  float* q_s = sm;
  float* acc = q_s + G * kd;
  float* s_s = acc + G * kd;
  float* m_s = s_s + G * DT;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < G * kd; i += NTHREADS) {
    const int g = i / kd, d = i % kd;
    q_s[i] = to_f(q[((size_t)b * G + g) * hk + (size_t)h * kd + d]);
    acc[i] = 0.f;
  }
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int n_rows = min(pos[b] + 1, t);
  const size_t plane = (size_t)B * t * hk;
  const size_t row0 = (size_t)b * t * hk + (size_t)h * kd;
  const T* kbase = cache + (size_t)(2 * layer) * plane + row0;
  const T* vbase = cache + (size_t)(2 * layer + 1) * plane + row0;
  const int nk = (kd + 31) / 32;
  __syncthreads();

  for (int t0 = 0; t0 < n_rows; t0 += DT) {
    const int rows = min(DT, n_rows - t0);
    // scores: warp w owns cache rows w, w + 4, ...; lanes split the head dim
    for (int r = warp; r < DT; r += NWARPS) {
      if (r < rows) {
        const T* krow = kbase + (size_t)(t0 + r) * hk;
        float kv[MAXKD / 32];
#pragma unroll
        for (int j = 0; j < MAXKD / 32; ++j) {
          const int d = lane + 32 * j;
          kv[j] = (j < nk && d < kd) ? to_f(krow[d]) : 0.f;
        }
        for (int g = 0; g < G; ++g) {
          const float* qg = q_s + g * kd;
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < MAXKD / 32; ++j) {
            const int d = lane + 32 * j;
            if (j < nk && d < kd) part = fmaf(qg[d], kv[j], part);
          }
          part = dl4j::warp_sum(part);
          if (lane == 0) s_s[g * DT + r] = part * scale;
        }
      } else if (lane == 0) {
        for (int g = 0; g < G; ++g) s_s[g * DT + r] = -INFINITY;
      }
    }
    __syncthreads();

    // online softmax per query row g (every tile holds >= 1 visible row)
    for (int g = warp; g < G; g += NWARPS) {
      float* srow = s_s + g * DT;
      float mx = -INFINITY;
      for (int c = lane; c < DT; c += 32) mx = fmaxf(mx, srow[c]);
      mx = dl4j::warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < DT; c += 32) {
        const float p = expf(srow[c] - m_new);
        sum += p;
        srow[c] = round_t<T>(p);  // PV operand in the value dtype
      }
      sum = dl4j::warp_sum(sum);
      if (lane == 0) {
        const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
        l_s[g] = corr * l_s[g] + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // PV: threads own head-dim columns; G rows in register chunks
    for (int d = tid; d < kd; d += NTHREADS) {
      for (int g0 = 0; g0 < G; g0 += GCHUNK) {
        const int ng = min(GCHUNK, G - g0);
        float a[GCHUNK];
#pragma unroll
        for (int j = 0; j < GCHUNK; ++j)
          a[j] = j < ng ? acc[(g0 + j) * kd + d] * c_s[g0 + j] : 0.f;
        for (int r = 0; r < rows; ++r) {
          const float vv = to_f(vbase[(size_t)(t0 + r) * hk + d]);
#pragma unroll
          for (int j = 0; j < GCHUNK; ++j)
            if (j < ng) a[j] = fmaf(s_s[(g0 + j) * DT + r], vv, a[j]);
        }
#pragma unroll
        for (int j = 0; j < GCHUNK; ++j)
          if (j < ng) acc[(g0 + j) * kd + d] = a[j];
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < G * kd; i += NTHREADS) {
    const int g = i / kd, d = i % kd;
    const float l = fmaxf(l_s[g], 1e-30f);
    out[((size_t)b * G + g) * hk + (size_t)h * kd + d] = from_f<T>(acc[i] / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* cache, const int* pos,
                   void* out, int B, int G, int hkv, int kd, int t, int layer,
                   float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, kd);
  cudaError_t err = dl4j::allow_smem(flash_decode_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(hkv, B);
  flash_decode_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache), pos,
      static_cast<T*>(out), B, G, hkv, kd, t, layer, scale);
  return cudaGetLastError();
}

}  // namespace

// q, out: (B, G, hkv*kd); cache: (n_layers, 2, B, t, hkv*kd) contiguous, in
// `dtype`; pos: (B,) int32 on the device. Returns cudaGetLastError().
extern "C" int dl4j_flash_decode(const void* q, const void* cache,
                                 const void* pos, void* out, int B, int G,
                                 int hkv, int kd, int t, int layer,
                                 float scale, int dtype, void* stream) {
  if (B <= 0 || G <= 0 || hkv <= 0 || kd <= 0 || kd > MAXKD || t <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(pos);
  if (dtype == dl4j::kF32)
    return (int)launch<float>(q, cache, p, out, B, G, hkv, kd, t, layer,
                              scale, s);
  if (dtype == dl4j::kBF16)
    return (int)launch<__nv_bfloat16>(q, cache, p, out, B, G, hkv, kd, t,
                                      layer, scale, s);
  return (int)cudaErrorInvalidValue;
}
