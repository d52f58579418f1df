// Flash attention forward (online softmax) for Hopper.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py `_flash_fwd_stream_kernel`
// (:125, launched by `_flash_fwd_call` :187), which serving reaches through
// `flash_attention` in bulk prefill (models/transformer.py:1133) and training
// through `flash_attention_trainable` (:482).
//
// Computes, for q, k, v of shape (BH, T, D) in f32 or bf16:
//   s   = (round_T(q * round_T(scale))) @ k^T          (f32 accumulation)
//   p   = exp(s - m_running)                           (f32)
//   o   = sum_tiles round_T(p) @ v / l                  (f32 accumulation)
//   lse = m + log(l)                                   (f32, (BH, T, 1))
// with the scale folded into the Q tile and the causal mask as in the
// reference: tiles wholly above the diagonal are never loaded, tiles that
// cross it (or the ragged edge) are masked element-wise, the others skip the
// mask. l sums the f32 p before rounding, as the reference does.
//
// Bound on the H100. At the training shape (BH 144, T 1024, D 128, causal,
// bf16) the call needs ~39 GFLOP against ~0.15 GB of HBM traffic: bound by
// the bf16 tensor-core rate. At the serving prefill shapes (BH 6, T <= 128)
// it moves < 1 MB and is bound by launch and latency (6 blocks).
//
// Bodies, a static table on (dtype, D) (`body_of`, exported as
// dl4j_flash_attn_fwd_body):
//   bf16, D 64 or 128 -> the tensor-core body (`flash_fwd_wgmma_kernel`);
//   f32, or D 16, 32, 256 -> the FMA body (`flash_fwd_kernel`): f32 stays
//     f32 (TF32 would change results beyond the reference's f32 semantics),
//     and the other head dims are not on any main path.
//
// Tensor-core body. One block owns 128 Q rows: two consumer warpgroups of 64
// rows and one producer warpgroup (40 registers a thread, the consumers
// 232). One producer thread issues TMA loads (a 3-D tensor map
// (D, T, BH), so a ragged last tile reads zeros and never the next head's
// rows) of the Q tile once and of 128-row K and V tiles into a 2-stage ring,
// each stage signalled by an mbarrier. Each consumer scales its Q rows in
// shared memory in place, then per KV tile: S = Qs K^T by wgmma m64n128k16
// (both operands in shared memory, K-major), the online softmax on the
// accumulator fragment (a row's max and sum span the 4 threads that hold
// it), P rounded to bf16 in registers as the register A operand of
// O += P V (V's tile MN-major, the transpose bit), and the stage released.
// A head's Q tiles launch together (its K and V stay in L2), heaviest first.
// The FMA body stages f32 tiles in shared memory and multiplies with scalar
// FMAs.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

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

// -- tensor-core body (bf16, D 64 / 128) ---------------------------------------

namespace tc {

using namespace dl4j::hopper;

constexpr int BM = 128;        // Q rows per block: two warpgroups of 64
constexpr int BN = 128;        // KV rows per tile
constexpr int STAGES = 2;      // K/V ring depth
constexpr int NTHREADS = 384;  // two consumer warpgroups + a producer
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Layout {
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // barriers: Q full, K full x STAGES, V full x STAGES, stage free x STAGES
  static constexpr size_t BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap qm,
                           __grid_constant__ const CUtensorMap km,
                           __grid_constant__ const CUtensorMap vm,
                           __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int t, float scale,
                           int causal) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle needs 1024-byte-aligned tiles
  uint8_t* smem = align_1024(smem_raw);
  uint8_t* qs = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* free_ = v_full + STAGES;

  // The Q tiles of one head are neighbours in launch order, so the blocks
  // that read a head's K and V run together and find them in L2; within a
  // head the heaviest tile (under the causal mask, the last) goes first.
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int q_last = min(q0 + BM, t) - 1;
  // causal: KV tiles past the Q tile's last row are invisible, never loaded
  const int n_tiles = causal ? q_last / BN + 1 : (t + BN - 1) / BN;
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(free_ + s, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // producer warpgroup: one thread issues every TMA load
    producer_regs();
    if (tid == 256) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      tma_load_tile<BM, D>(qs, &qm, q_full, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(free_ + s, (j / STAGES - 1) & 1);
        mbar_expect_tx(k_full + s, L::KV_BYTES);
        tma_load_tile<BN, D>(smem + L::K_OFF + s * L::KV_BYTES, &km,
                             k_full + s, j * BN, bh);
        mbar_expect_tx(v_full + s, L::KV_BYTES);
        tma_load_tile<BN, D>(smem + L::V_OFF + s * L::KV_BYTES, &vm,
                             v_full + s, j * BN, bh);
      }
    }
    return;
  }

  // consumer warpgroup wg owns Q rows q0 + 64 wg .. + 63
  consumer_regs();
  const int wg = tid / 128;
  const int lane = tid % 32;
  const int row = q0 + 64 * wg + 16 * ((tid % 128) / 32) + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);  // fragment column within each 8-column group

  mbar_wait(q_full, 0);
  // the reference multiplies by the scale cast to the input dtype
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    scale_bf16_inplace(qs + p * BM * 128 + wg * 64 * 128, 64 * 128 / 16,
                       scale_t, tid % 128, 128);
  fence_proxy_async();
  bar_sync(1 + wg, 128);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's partial row sums

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int ph = (j / STAGES) & 1;
    const int k0 = j * BN;
    const uint8_t* ks = smem + L::K_OFF + s * L::KV_BYTES;
    const uint8_t* vs = smem + L::V_OFF + s * L::KV_BYTES;

    mbar_wait(k_full + s, ph);
    float sc[BN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BN>(sc, desc_k<BM>(qs, 64 * wg, kk), desc_k<BN>(ks, 0, kk),
                   kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // only the ragged edge and diagonal-crossing tiles pay the mask
    if (k0 + BN > t || (causal && k0 + BN - 1 > q0 + 64 * wg)) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int c = k0 + 8 * (i / 4) + col + (i % 2);
        const int r = row + 8 * ((i / 2) % 2);
        if (c >= t || (causal && c > r)) sc[i] = -INFINITY;
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        if ((i / 2) % 2 == h) mx = fmaxf(mx, sc[i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      corr[h] = m[h] == -INFINITY ? 0.f : fast_exp2((m[h] - m_new) * LOG2E);
      // a row with nothing visible yet keeps p = 0 (no -inf - -inf)
      m[h] = m_new;
      l[h] *= corr[h];
    }
    const float mb[2] = {(m[0] == -INFINITY ? 0.f : m[0]) * LOG2E,
                         (m[1] == -INFINITY ? 0.f : m[1]) * LOG2E};
    uint32_t pa[BN / 16][4];  // round_T(p): the register A operand of PV
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int h = (i / 2) % 2;
      const float p0 = fast_exp2(fmaf(sc[i], LOG2E, -mb[h]));
      const float p1 = fast_exp2(fmaf(sc[i + 1], LOG2E, -mb[h]));
      l[h] += p0 + p1;
      pa[i / 8][(i % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i / 2) % 2];

    mbar_wait(v_full + s, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs_tb<D>(acc, pa[kk], desc_mn<BN>(vs, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(pa);
    // the stage goes back to the producer: one arrival per consumer warp,
    // after the warp's products that read it have completed
    if (lane == 0) mbar_arrive(free_ + s);
  }

  const size_t base = (size_t)bh * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lt = l[h];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int r = row + 8 * h;
    if (r >= t) continue;
    const float lc = fmaxf(lt, 1e-30f);
    __nv_bfloat16* orow = o + (base + r) * D;
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {
      const int i = 4 * g + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * g + col) =
          __floats2bfloat162_rn(acc[i] / lc, acc[i + 1] / lc);
    }
    if (lane % 4 == 0) lse[base + r] = m[h] + logf(lc);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int t, float scale, int causal,
                   cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  cudaError_t err = make_tile_map(&qm, q, bh, t, D, BM);
  if (err == cudaSuccess) err = make_tile_map(&km, k, bh, t, D, BN);
  if (err == cudaSuccess) err = make_tile_map(&vm, v, bh, t, D, BN);
  if (err != cudaSuccess) return err;
  const size_t smem = Layout<D>::BYTES;
  err = dl4j::allow_smem(flash_fwd_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + BM - 1) / BM, bh);
  flash_fwd_wgmma_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), t,
      scale, causal);
  return cudaGetLastError();
}

}  // namespace tc

// which body a (dtype, D) call takes: the static table of the source note
enum Body : int { kFma = 0, kWgmma = 1 };

Body body_of(int dtype, int d) {
  return dtype == dl4j::kBF16 && (d == 64 || d == 128) ? kWgmma : kFma;
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

// q, k, v, o: (bh, t, d) contiguous in `dtype` (16-byte aligned for the
// tensor-core body's TMA); lse: (bh, t) f32.
// Returns the launch's cudaGetLastError() (0 on success).
extern "C" int dl4j_flash_attn_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int t, int d, float scale, int causal,
                                   int dtype, void* stream) {
  if (bh <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body_of(dtype, d) == kWgmma)
    return (int)(d == 64 ? tc::launch<64>(q, k, v, o, lse, bh, t, scale, causal, s)
                         : tc::launch<128>(q, k, v, o, lse, bh, t, scale, causal, s));
  if (dtype == dl4j::kF32)
    return (int)dispatch_d<float>(q, k, v, o, lse, bh, t, d, scale, causal, s);
  if (dtype == dl4j::kBF16)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, t, d, scale,
                                          causal, s);
  return (int)cudaErrorInvalidValue;
}

// The body a call with this dtype code and head dim takes: 0 the FMA body,
// 1 the tensor-core (wgmma) body.
extern "C" int dl4j_flash_attn_fwd_body(int dtype, int d) {
  return (int)body_of(dtype, d);
}
