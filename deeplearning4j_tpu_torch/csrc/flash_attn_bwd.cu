// Flash attention backward for Hopper: dQ, dK, dV in two deterministic passes.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py `_flash_bwd_fused_kernel`
// (:213, launched by `_flash_bwd_rule` :358), the backward of
// `flash_attention_trainable` that the transformer's training block runs.
//
// Computes, for q, k, v, dO of shape (BH, T, D) in f32 or bf16, with lse and
// delta = sum_d f32(dO) * f32(O) of shape (BH, T) f32 (delta is a plain
// PyTorch reduction in the wrapper, as the reference computes it outside its
// kernel):
//   qs = round_T(q * round_T(scale))
//   p  = exp(qs @ k^T - lse)                          (f32; 0 where masked)
//   dV = sum_q round_T(p)^T @ dO                      (f32 accumulation)
//   dp = dO @ v^T                                     (f32)
//   ds = round_T(round_T(p) * round_T(dp - delta))    (product in the storage type)
//   dK = sum_q ds^T @ qs                              (the scaled q absorbs the scale)
//   dQ = round_T(scale * sum_k ds @ k)
// rounding exactly where the reference does (`_flash_bwd_fused_kernel`
// :249-:274). Each gradient is cast to the storage type once.
//
// Design. The reference's grid runs in order on one core: it carries dK/dV in
// VMEM across the Q blocks of one KV block and accumulates dQ in HBM across
// KV blocks. Blocks on Hopper run in no order, so one pass would need float
// atomics for dQ, whose sums change from run to run. Instead, two passes in
// this one source:
//   pass 1: one block per (BH row, 64-row KV tile); the K/V tiles stay in
//           shared memory and dK/dV accumulate in f32 registers over the
//           visible Q tiles;
//   pass 2: one block per (BH row, 64-row Q tile); dQ accumulates in f32
//           registers over the visible KV tiles.
// Both passes recompute S and P (7 tile products against the reference's 5),
// and every sum runs in a fixed order, so the result is bitwise reproducible.
// Tiles wholly above the causal diagonal are never loaded; tiles that cross
// it or the ragged edge are masked element-wise.
//
// Bound on the H100: at the training shape (BH 144, T 1024, D 128, causal,
// bf16) the 5 products the function needs are ~97 GFLOP against ~0.3 GB of
// HBM traffic, so it is bound by operations (~0.1 ms at 989 TFLOP/s). The
// products here are plain f32 FMA loops out of shared memory, far from that
// rate; tensor cores (mma.sync / wgmma) and TMA are later work.

#include <math.h>

#include "common.cuh"

namespace {

using dl4j::from_f;
using dl4j::round_t;
using dl4j::to_f;

constexpr int NTHREADS = 256;  // 16 x 16 thread grid
constexpr int OWN = 64;        // rows a block owns: KV rows (pass 1), Q rows (pass 2)

// rows of each streamed tile: 32 at D = 256 keeps a block under 227 KB
template <int D>
constexpr int kStream = D > 128 ? 32 : 64;

// A (BQ x BK) tile pair in shared memory: the scaled q and dO tiles of BQ
// rows, the k and v tiles of BK rows (f32, row stride D + 1 keeps column
// reads conflict-free), the round_T(p) and ds tiles, and lse / delta per Q row.
template <int D, int BQ, int BK>
struct Tiles {
  static constexpr size_t bytes() {
    return sizeof(float) * ((size_t)2 * BQ * (D + 1) + (size_t)2 * BK * (D + 1) +
                            (size_t)2 * BQ * (BK + 1) + 2 * BQ);
  }
  float *qs, *dos, *ks, *vs, *ps, *dss, *lse, *delta;
  __device__ explicit Tiles(float* smem) {
    qs = smem;
    dos = qs + BQ * (D + 1);
    ks = dos + BQ * (D + 1);
    vs = ks + BK * (D + 1);
    ps = vs + BK * (D + 1);
    dss = ps + BQ * (BK + 1);
    lse = dss + BQ * (BK + 1);
    delta = lse + BQ;
  }
};

// rows [r0, r0 + ROWS) of one (t, D) matrix into a tile of row stride D + 1;
// rows past t are zero. SCALE rounds q * round_T(scale) through the storage
// type, as the reference scales its Q tile.
template <typename T, int D, int ROWS, bool SCALE>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int r0, int t, float scale_t) {
  for (int i = threadIdx.x; i < ROWS * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (r0 + r < t) {
      x = to_f(src[(size_t)(r0 + r) * D + c]);
      if (SCALE) x = round_t<T>(x * scale_t);
    }
    dst[r * (D + 1) + c] = x;
  }
}

template <int ROWS>
__device__ __forceinline__ void load_row_stats(float* lse_s, float* delta_s,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ delta,
                                               int r0, int t) {
  for (int r = threadIdx.x; r < ROWS; r += NTHREADS) {
    const bool in = r0 + r < t;
    lse_s[r] = in ? lse[r0 + r] : 0.f;
    delta_s[r] = in ? delta[r0 + r] : 0.f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d]
template <int D, int NI, int NJ>
__device__ __forceinline__ void dot_rows(float (&acc)[NI][NJ], const float* a,
                                         const float* b, int tx, int ty) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float av[NI], bv[NJ];
#pragma unroll
    for (int i = 0; i < NI; ++i) av[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < NI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// p and ds of the (BQ x BK) tile at rows q0, columns k0, from the tiles in
// shared memory. Thread (ty, tx) computes rows ty + 16 i, columns tx + 16 j,
// and writes ds (and round_T(p) when WRITE_P) back to shared memory.
template <typename T, int D, int BQ, int BK, bool WRITE_P>
__device__ __forceinline__ void p_and_ds(const Tiles<D, BQ, BK>& sm, int q0,
                                         int k0, int t, int causal, int tx,
                                         int ty) {
  constexpr int NI = BQ / 16, NJ = BK / 16, LP = BK + 1;
  float s[NI][NJ], dp[NI][NJ];
  dot_rows<D, NI, NJ>(s, sm.qs, sm.ks, tx, ty);
  dot_rows<D, NI, NJ>(dp, sm.dos, sm.vs, tx, ty);
  // only the ragged edge and diagonal-crossing tiles pay the mask
  const bool masked =
      q0 + BQ > t || k0 + BK > t || (causal && k0 + BK - 1 > q0);
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int rl = ty + 16 * i;
    const int r = q0 + rl;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int cl = tx + 16 * j;
      const int c = k0 + cl;
      float p = 0.f;
      if (!masked || (r < t && c < t && !(causal && c > r)))
        p = expf(s[i][j] - sm.lse[rl]);
      const float pr = round_t<T>(p);
      if (WRITE_P) sm.ps[rl * LP + cl] = pr;
      sm.dss[rl * LP + cl] = round_t<T>(pr * round_t<T>(dp[i][j] - sm.delta[rl]));
    }
  }
}

// pass 1: dK and dV of one 64-row KV tile
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, T* __restrict__ dk,
                          T* __restrict__ dv, int t, float scale, int causal) {
  constexpr int BQ = kStream<D>, BK = OWN;
  constexpr int LD = D + 1, LP = BK + 1, NC = D / 16;
  extern __shared__ float smem[];
  const Tiles<D, BQ, BK> sm(smem);

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const size_t base = (size_t)bh * t * D;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float scale_t = round_t<T>(scale);

  load_rows<T, D, BK, false>(sm.ks, k + base, k0, t, 0.f);
  load_rows<T, D, BK, false>(sm.vs, v + base, k0, t, 0.f);

  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (t + BQ - 1) / BQ;
  // causal: Q tiles that end before k0 see none of this KV tile
  for (int qt = causal ? k0 / BQ : 0; qt < n_q; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's readers are done
    load_rows<T, D, BQ, true>(sm.qs, q + base, q0, t, scale_t);
    load_rows<T, D, BQ, false>(sm.dos, dout + base, q0, t, 0.f);
    load_row_stats<BQ>(sm.lse, sm.delta, lse + (size_t)bh * t,
                       delta + (size_t)bh * t, q0, t);
    __syncthreads();
    p_and_ds<T, D, BQ, BK, true>(sm, q0, k0, t, causal, tx, ty);
    __syncthreads();
    // dV += round_T(P)^T dO, dK += dS^T qs; this thread's KV rows are
    // ty + 16 i, its columns tx + 16 c
    for (int r = 0; r < BQ; ++r) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = sm.ps[r * LP + ty + 16 * i];
        dsv[i] = sm.dss[r * LP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float dov = sm.dos[r * LD + tx + 16 * c];
        const float qv = sm.qs[r * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][c] = fmaf(pv[i], dov, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= t) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const size_t off = base + (size_t)r * D + tx + 16 * c;
      dk[off] = from_f<T>(dk_acc[i][c]);
      dv[off] = from_f<T>(dv_acc[i][c]);
    }
  }
}

// pass 2: dQ of one 64-row Q tile
template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int t, float scale, int causal) {
  constexpr int BQ = OWN, BK = kStream<D>;
  constexpr int LD = D + 1, LP = BK + 1, NC = D / 16;
  extern __shared__ float smem[];
  const Tiles<D, BQ, BK> sm(smem);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * t * D;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_rows<T, D, BQ, true>(sm.qs, q + base, q0, t, round_t<T>(scale));
  load_rows<T, D, BQ, false>(sm.dos, dout + base, q0, t, 0.f);
  load_row_stats<BQ>(sm.lse, sm.delta, lse + (size_t)bh * t,
                     delta + (size_t)bh * t, q0, t);

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int q_last = min(q0 + BQ, t) - 1;
  // causal: KV tiles past the Q tile's last row are invisible, never loaded
  const int n_k = causal ? q_last / BK + 1 : (t + BK - 1) / BK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done with ks/dss
    load_rows<T, D, BK, false>(sm.ks, k + base, k0, t, 0.f);
    load_rows<T, D, BK, false>(sm.vs, v + base, k0, t, 0.f);
    __syncthreads();
    p_and_ds<T, D, BQ, BK, false>(sm, q0, k0, t, causal, tx, ty);
    __syncthreads();
    // dQ += dS k; this thread's Q rows are ty + 16 i, its columns tx + 16 c
    for (int j = 0; j < BK; ++j) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = sm.dss[(ty + 16 * i) * LP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = sm.ks[j * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= t) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      dq[base + (size_t)r * D + tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, int bh, int t, float scale,
                   int causal, cudaStream_t stream) {
  constexpr int S = kStream<D>;
  const size_t smem1 = Tiles<D, S, OWN>::bytes();
  const size_t smem2 = Tiles<D, OWN, S>::bytes();
  cudaError_t err = dl4j::allow_smem(flash_bwd_dkdv_kernel<T, D>, smem1);
  if (err != cudaSuccess) return err;
  err = dl4j::allow_smem(flash_bwd_dq_kernel<T, D>, smem2);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + OWN - 1) / OWN, bh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  flash_bwd_dkdv_kernel<T, D><<<grid, NTHREADS, smem1, stream>>>(
      qt, kt, vt, dot, lf, df, static_cast<T*>(dk), static_cast<T*>(dv), t,
      scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D><<<grid, NTHREADS, smem2, stream>>>(
      qt, kt, vt, dot, lf, df, static_cast<T*>(dq), t, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, void* dk, void* dv, int bh, int t, int d,
                       float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t, scale, causal, s);
    case 32:
      return launch<T, 32>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t, scale, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t, scale, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t, scale, causal, s);
    case 256:
      return launch<T, 256>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t, scale, causal, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, dout, dq, dk, dv: (bh, t, d) contiguous in `dtype`; lse, delta:
// (bh, t) f32. Launches pass 1 (dK, dV) then pass 2 (dQ) on `stream`.
// Returns the launches' cudaGetLastError() (0 on success).
extern "C" int dl4j_flash_attn_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq, void* dk,
                                   void* dv, int bh, int t, int d, float scale,
                                   int causal, int dtype, void* stream) {
  if (bh <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == dl4j::kF32)
    return (int)dispatch_d<float>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t,
                                  d, scale, causal, s);
  if (dtype == dl4j::kBF16)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk,
                                          dv, bh, t, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
