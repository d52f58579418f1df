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
// HBM traffic, so it is bound by the bf16 tensor-core rate (~0.1 ms at 989
// TFLOP/s).
//
// Bodies, a static table on (dtype, D) (`body_of`, exported as
// dl4j_flash_attn_bwd_body):
//   bf16, D 64 or 128 -> the tensor-core bodies (`flash_bwd_dkdv_wgmma_kernel`,
//     `flash_bwd_dq_wgmma_kernel`);
//   f32, or D 16, 32, 256 -> the FMA bodies (`flash_bwd_dkdv_kernel`,
//     `flash_bwd_dq_kernel`): f32 stays f32 (TF32 would change results
//     beyond the reference's f32 semantics); at D 256 the dK/dV accumulators
//     of 64 KV rows alone would be 256 f32 registers a thread.
//
// Tensor-core bodies: every product is a wgmma with f32 accumulators in
// registers. A block is two consumer warpgroups of 64 owned rows (232
// registers a thread) and one producer warpgroup (40), of which one thread
// loads the owned tiles once and the streamed tiles through a 3-stage ring
// by TMA (a 3-D tensor map (D, T, BH), so a ragged last tile reads zeros,
// never the next head's rows), one mbarrier per stage.
//   pass 1 (128 KV rows a block, 64-row Q/dO tiles streamed): the transposed
//     tiles come out of the products directly, KV rows as M, so nothing is
//     transposed through shared memory: S^T = K Qs^T and dP^T = V dO^T
//     (K-major operands), then bf16 P^T and dS^T are the register A operands
//     of dV += P^T dO and dK += dS^T Qs (dO and Qs MN-major, the transpose
//     bit); lse and delta are read per column.
//   pass 2 (128 Q rows a block, 64-row K/V tiles streamed): S = Qs K^T and
//     dP = dO V^T, then dQ += dS K with dS from registers and K MN-major.
//   Pass 2 runs first: it scales its Q rows in shared memory and also
//   writes them to a scratch tensor, which pass 1 streams as its Q tiles, so
//   the two warpgroups of a pass-1 block never wait on each other.
// No float atomics anywhere: each output element is summed by one thread in
// a fixed order, so the result is bitwise reproducible.
// The FMA bodies stage f32 tiles in shared memory (row stride D + 1) and
// multiply with scalar FMAs.

#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

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

// -- tensor-core bodies (bf16, D 64 / 128) -------------------------------------

namespace tc {

using namespace dl4j::hopper;

constexpr int OWN = 128;       // rows a block owns: two warpgroups of 64
constexpr int STREAM = 64;     // rows of each streamed tile
constexpr int STAGES = 3;      // ring depth of the streamed tiles
constexpr int NTHREADS = 384;  // two consumer warpgroups + a producer
constexpr float LOG2E = 1.4426950408889634f;

// Both passes: two owned (OWN x D) tiles, then STAGES pairs of streamed
// (STREAM x D) tiles, then pass 1's per-stage lse (times log2 e) and delta
// of the streamed Q rows, then the barriers: owned full, stage full x
// STAGES, stage free x STAGES.
template <int D>
struct Layout {
  static constexpr int OWN_BYTES = OWN * D * 2;
  static constexpr int STREAM_BYTES = STREAM * D * 2;
  static constexpr int A_OFF = 0;  // owned tile 1: K (pass 1) or Q (pass 2)
  static constexpr int B_OFF = OWN_BYTES;  // owned tile 2: V or dO
  // streamed tile 1 (Q or K) of stage s
  static constexpr int C_OFF = 2 * OWN_BYTES;
  // streamed tile 2 (dO or V) of stage s
  static constexpr int E_OFF = C_OFF + STAGES * STREAM_BYTES;
  static constexpr int STAT_OFF = E_OFF + STAGES * STREAM_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * STREAM * 4;
  static constexpr size_t BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

struct Bars {
  uint64_t *own, *full, *free_;
  __device__ explicit Bars(uint8_t* p)
      : own(reinterpret_cast<uint64_t*>(p)), full(own + 1),
        free_(own + 1 + STAGES) {}
};

// thread 0 initialises the barriers (a stage is full after `full_count`
// arrivals and its TMA bytes); every thread waits for it
__device__ __forceinline__ void init_bars(const Bars& bars, int full_count) {
  if (threadIdx.x == 0) {
    mbar_init(bars.own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars.full + s, full_count);
      mbar_init(bars.free_ + s, 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// the producer's loop: owned tiles (rows own0) once, then streamed tiles
// first .. first + n - 1 into the ring
template <int D>
__device__ __forceinline__ void produce(uint8_t* smem, const Bars& bars,
                                        const CUtensorMap* own_a,
                                        const CUtensorMap* own_b,
                                        const CUtensorMap* str_c,
                                        const CUtensorMap* str_e, int own0,
                                        int first, int n, int bh) {
  using L = Layout<D>;
  mbar_expect_tx(bars.own, 2 * L::OWN_BYTES);
  tma_load_tile<OWN, D>(smem + L::A_OFF, own_a, bars.own, own0, bh);
  tma_load_tile<OWN, D>(smem + L::B_OFF, own_b, bars.own, own0, bh);
  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(bars.free_ + s, (j / STAGES - 1) & 1);
    mbar_expect_tx(bars.full + s, 2 * L::STREAM_BYTES);
    const int r0 = (first + j) * STREAM;
    tma_load_tile<STREAM, D>(smem + L::C_OFF + s * L::STREAM_BYTES, str_c,
                             bars.full + s, r0, bh);
    tma_load_tile<STREAM, D>(smem + L::E_OFF + s * L::STREAM_BYTES, str_e,
                             bars.full + s, r0, bh);
  }
}

// pass 1's second producer warp: lse (times log2 e) and delta of each
// streamed Q tile into its stage, zeros past T; after the warp's barrier,
// lane 0's arrival on the stage's full barrier releases the stores
template <int D>
__device__ __forceinline__ void produce_stats(uint8_t* smem, const Bars& bars,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              int first, int n, int t,
                                              int lane) {
  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(bars.free_ + s, (j / STAGES - 1) & 1);
    float* stat =
        reinterpret_cast<float*>(smem + Layout<D>::STAT_OFF) + s * 2 * STREAM;
    const int q0 = (first + j) * STREAM;
    for (int i = lane; i < STREAM; i += 32) {
      const bool in = q0 + i < t;
      stat[i] = in ? lse[q0 + i] * LOG2E : 0.f;
      stat[STREAM + i] = in ? delta[q0 + i] : 0.f;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars.full + s);
  }
}

// pass 1: dK and dV of 128 KV rows; qm maps the scaled Q that pass 2 wrote
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkdv_wgmma_kernel(__grid_constant__ const CUtensorMap qm,
                                __grid_constant__ const CUtensorMap km,
                                __grid_constant__ const CUtensorMap vm,
                                __grid_constant__ const CUtensorMap dom,
                                const float* __restrict__ lse,
                                const float* __restrict__ delta,
                                __nv_bfloat16* __restrict__ dk,
                                __nv_bfloat16* __restrict__ dv, int t,
                                int causal) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const Bars bars(smem + L::BAR_OFF);
  init_bars(bars, 2);  // the TMA thread and the stats warp

  // a head's KV tiles are neighbours in launch order (its Q and dO stay in
  // L2); the first is the heaviest under the causal mask and goes first
  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * OWN;
  // causal: Q tiles that end before kv0 see none of these KV rows
  const int first = causal ? kv0 / STREAM : 0;
  const int n = (t + STREAM - 1) / STREAM - first;
  const int tid = threadIdx.x;

  if (tid >= 256) {
    producer_regs();
    if (tid == 256) produce<D>(smem, bars, &km, &vm, &qm, &dom, kv0, first, n, bh);
    if (tid >= 288 && tid < 320)
      produce_stats<D>(smem, bars, lse + (size_t)bh * t,
                       delta + (size_t)bh * t, first, n, t, tid - 288);
    return;
  }
  consumer_regs();

  const int wg = tid / 128;
  const int lane = tid % 32;
  const int kvw = kv0 + 64 * wg;  // this warpgroup's first KV row
  const int row = kvw + 16 * ((tid % 128) / 32) + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  const uint8_t* ks = smem + L::A_OFF;
  const uint8_t* vs = smem + L::B_OFF;

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(bars.own, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES;
    const int q0 = (first + j) * STREAM;
    const uint8_t* qs = smem + L::C_OFF + s * L::STREAM_BYTES;
    const uint8_t* dos = smem + L::E_OFF + s * L::STREAM_BYTES;
    const float* stat =
        reinterpret_cast<const float*>(smem + L::STAT_OFF) + s * 2 * STREAM;
    mbar_wait(bars.full + s, (j / STAGES) & 1);

    // S^T = K Qs^T and dP^T = V dO^T (64 KV rows x 64 q columns)
    float st[STREAM / 2], dpt[STREAM / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<STREAM>(st, desc_k<OWN>(ks, 64 * wg, kk),
                       desc_k<STREAM>(qs, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<STREAM>(dpt, desc_k<OWN>(vs, 64 * wg, kk),
                       desc_k<STREAM>(dos, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // only the ragged edges and diagonal-crossing tiles pay the mask
    const bool masked = q0 + STREAM > t || kvw + 64 > t ||
                        (causal && q0 < kvw + 63);
    // round_T(p)^T and dS^T = round_T(round_T(p) * round_T(dp - delta)),
    // the A operands of dV and dK
    uint32_t pa[STREAM / 16][4], dsa[STREAM / 16][4];
    // by 8-column groups g: values 4 g + 2 h + {0, 1} of the fragment are
    // row row + 8 h, columns 8 g + col + {0, 1}; each column's lse and delta
    // serve both rows, and each pair is rounded by one paired conversion
#pragma unroll
    for (int g = 0; g < STREAM / 8; ++g) {
      const int cl = 8 * g + col;
      const int c = q0 + cl;
      const float l0 = stat[cl], l1 = stat[cl + 1];
      const float d0 = stat[STREAM + cl], d1 = stat[STREAM + cl + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * g + 2 * h;
        const int r = row + 8 * h;
        const bool vis0 = !masked || (c < t && r < t && !(causal && r > c));
        const bool vis1 =
            !masked || (c + 1 < t && r < t && !(causal && r > c + 1));
        const uint32_t p = pack_bf16(
            vis0 ? fast_exp2(fmaf(st[i], LOG2E, -l0)) : 0.f,
            vis1 ? fast_exp2(fmaf(st[i + 1], LOG2E, -l1)) : 0.f);
        const uint32_t dd = pack_bf16(dpt[i] - d0, dpt[i + 1] - d1);
        pa[g / 2][2 * (g % 2) + h] = p;
        dsa[g / 2][2 * (g % 2) + h] = pack_bf16(bf16_lo(p) * bf16_lo(dd),
                                                bf16_hi(p) * bf16_hi(dd));
      }
    }

    // dV += P^T dO and dK += dS^T Qs (dO and Qs MN-major)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < STREAM / 16; ++kk)
      wgmma_rs_tb<D>(dv_acc, pa[kk], desc_mn<STREAM>(dos, kk), 1);
#pragma unroll
    for (int kk = 0; kk < STREAM / 16; ++kk)
      wgmma_rs_tb<D>(dk_acc, dsa[kk], desc_mn<STREAM>(qs, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    fence_regs(pa);
    fence_regs(dsa);
    // the stage goes back to the producer: one arrival per consumer warp,
    // after the warp's products and stats reads that use it have completed
    if (lane == 0) mbar_arrive(bars.free_ + s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= t) continue;
    const size_t off = ((size_t)bh * t + r) * D + col;
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {
      const int i = 4 * g + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * g) =
          __floats2bfloat162_rn(dk_acc[i], dk_acc[i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * g) =
          __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
    }
  }
}

// pass 2: dQ of 128 Q rows
template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap qm,
                              __grid_constant__ const CUtensorMap km,
                              __grid_constant__ const CUtensorMap vm,
                              __grid_constant__ const CUtensorMap dom,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq,
                              __nv_bfloat16* __restrict__ qs_out, int t,
                              float scale, int causal) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_1024(smem_raw);
  const Bars bars(smem + L::BAR_OFF);
  init_bars(bars, 1);

  // a head's Q tiles are neighbours in launch order (its K and V stay in
  // L2); the last is the heaviest under the causal mask and goes first
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * OWN;
  const int q_last = min(q0 + OWN, t) - 1;
  // causal: KV tiles past the Q tile's last row are invisible, never loaded
  const int n = causal ? q_last / STREAM + 1 : (t + STREAM - 1) / STREAM;
  const int tid = threadIdx.x;

  if (tid >= 256) {
    producer_regs();
    if (tid == 256) produce<D>(smem, bars, &qm, &dom, &km, &vm, q0, 0, n, bh);
    return;
  }
  consumer_regs();

  const int wg = tid / 128;
  const int lane = tid % 32;
  const int qw = q0 + 64 * wg;  // this warpgroup's first Q row
  const int row = qw + 16 * ((tid % 128) / 32) + lane / 4;  // and row + 8
  const int col = 2 * (lane % 4);
  uint8_t* qs = smem + L::A_OFF;
  const uint8_t* dos = smem + L::B_OFF;

  float lse2[2], delta_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    lse2[h] = r < t ? lse[(size_t)bh * t + r] * LOG2E : 0.f;
    delta_r[h] = r < t ? delta[(size_t)bh * t + r] : 0.f;
  }

  mbar_wait(bars.own, 0);
  // the reference multiplies by the scale cast to the input dtype
  const float scale_t = __bfloat162float(__float2bfloat16_rn(scale));
#pragma unroll
  for (int p = 0; p < D / 64; ++p) {
    uint8_t* rows = qs + p * OWN * 128 + wg * 64 * 128;
    scale_bf16_inplace(rows, 64 * 128 / 16, scale_t, tid % 128, 128);
    // pass 1 reads the scaled Q back: each thread stores the 16-byte chunks
    // it scaled, undoing the swizzle (chunk c of row r holds columns
    // 8 (c ^ (r % 8)) .. + 7 of the panel)
    for (int i = tid % 128; i < 64 * 8; i += 128) {
      const int r = qw + i / 8;
      if (r >= t) break;
      const int c = 64 * p + 8 * ((i % 8) ^ ((i / 8) % 8));
      *reinterpret_cast<uint4*>(qs_out + ((size_t)bh * t + r) * D + c) =
          reinterpret_cast<const uint4*>(rows)[i];
    }
  }
  fence_proxy_async();
  bar_sync(1 + wg, 128);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES;
    const int k0 = j * STREAM;
    const uint8_t* ks = smem + L::C_OFF + s * L::STREAM_BYTES;
    const uint8_t* vs = smem + L::E_OFF + s * L::STREAM_BYTES;
    mbar_wait(bars.full + s, (j / STAGES) & 1);

    // S = Qs K^T and dP = dO V^T (64 q rows x 64 KV columns)
    float sc[STREAM / 2], dp[STREAM / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<STREAM>(sc, desc_k<OWN>(qs, 64 * wg, kk),
                       desc_k<STREAM>(ks, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<STREAM>(dp, desc_k<OWN>(dos, 64 * wg, kk),
                       desc_k<STREAM>(vs, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // only the ragged edges and diagonal-crossing tiles pay the mask
    const bool masked = qw + 64 > t || k0 + STREAM > t ||
                        (causal && k0 + STREAM - 1 > qw);
    uint32_t dsa[STREAM / 16][4];  // dS, the A operand of dQ
    // each pair of columns is rounded by one paired conversion
#pragma unroll
    for (int i = 0; i < STREAM / 2; i += 2) {
      const int h = (i / 2) % 2;
      const int r = row + 8 * h;
      const int c = k0 + 8 * (i / 4) + col;
      const bool vis0 = !masked || (c < t && r < t && !(causal && c > r));
      const bool vis1 =
          !masked || (c + 1 < t && r < t && !(causal && c + 1 > r));
      const uint32_t p = pack_bf16(
          vis0 ? fast_exp2(fmaf(sc[i], LOG2E, -lse2[h])) : 0.f,
          vis1 ? fast_exp2(fmaf(sc[i + 1], LOG2E, -lse2[h])) : 0.f);
      const uint32_t dd =
          pack_bf16(dp[i] - delta_r[h], dp[i + 1] - delta_r[h]);
      dsa[i / 8][(i % 8) / 2] = pack_bf16(bf16_lo(p) * bf16_lo(dd),
                                          bf16_hi(p) * bf16_hi(dd));
    }

    // dQ += dS K (K MN-major)
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < STREAM / 16; ++kk)
      wgmma_rs_tb<D>(acc, dsa[kk], desc_mn<STREAM>(ks, kk), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(dsa);
    if (lane == 0) mbar_arrive(bars.free_ + s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    if (r >= t) continue;
    __nv_bfloat16* out = dq + ((size_t)bh * t + r) * D + col;
#pragma unroll
    for (int g = 0; g < D / 8; ++g) {
      const int i = 4 * g + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * g) =
          __floats2bfloat162_rn(acc[i] * scale, acc[i + 1] * scale);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, void* dk, void* dv, void* qs, int bh, int t,
                   float scale, int causal, cudaStream_t stream) {
  // pass 2 owns Q/dO rows and streams K/V; pass 1 the other way round, over
  // the scaled Q that pass 2 writes to qs
  CUtensorMap q_own, qs_str, k_own, k_str, v_own, v_str, do_own, do_str;
  const void* bases[4] = {q, k, v, dout};
  CUtensorMap* owned[4] = {&q_own, &k_own, &v_own, &do_own};
  CUtensorMap* streamed[4] = {&qs_str, &k_str, &v_str, &do_str};
  cudaError_t err = cudaSuccess;
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    err = make_tile_map(owned[i], bases[i], bh, t, D, OWN);
    if (err == cudaSuccess)
      err = make_tile_map(streamed[i], i == 0 ? qs : bases[i], bh, t, D,
                          STREAM);
  }
  if (err != cudaSuccess) return err;
  const size_t smem = Layout<D>::BYTES;
  err = dl4j::allow_smem(flash_bwd_dkdv_wgmma_kernel<D>, smem);
  if (err == cudaSuccess)
    err = dl4j::allow_smem(flash_bwd_dq_wgmma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + OWN - 1) / OWN, bh);
  const float* lf = static_cast<const float*>(lse);
  const float* df = static_cast<const float*>(delta);
  flash_bwd_dq_wgmma_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      q_own, k_str, v_str, do_own, lf, df, static_cast<__nv_bfloat16*>(dq),
      static_cast<__nv_bfloat16*>(qs), t, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_wgmma_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      qs_str, k_own, v_own, do_str, lf, df, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), t, causal);
  return cudaGetLastError();
}

}  // namespace tc

// which bodies a (dtype, D) call takes: the static table of the source note
enum Body : int { kFma = 0, kWgmma = 1 };

Body body_of(int dtype, int d) {
  return dtype == dl4j::kBF16 && (d == 64 || d == 128) ? kWgmma : kFma;
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

// q, k, v, dout, dq, dk, dv: (bh, t, d) contiguous in `dtype` (16-byte
// aligned for the tensor-core bodies' TMA); lse, delta: (bh, t) f32; qs:
// (bh, t, d) scratch the tensor-core bodies write the scaled q to (unused
// by the FMA bodies). Launches both passes on `stream`: the FMA bodies
// pass 1 (dK, dV) then pass 2 (dQ), the tensor-core bodies pass 2 first.
// Returns the launches' cudaGetLastError() (0 on success).
extern "C" int dl4j_flash_attn_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq, void* dk,
                                   void* dv, void* qs, int bh, int t, int d,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  if (bh <= 0 || t <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body_of(dtype, d) == kWgmma)
    return (int)(d == 64 ? tc::launch<64>(q, k, v, dout, lse, delta, dq, dk,
                                          dv, qs, bh, t, scale, causal, s)
                         : tc::launch<128>(q, k, v, dout, lse, delta, dq, dk,
                                           dv, qs, bh, t, scale, causal, s));
  if (dtype == dl4j::kF32)
    return (int)dispatch_d<float>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t,
                                  d, scale, causal, s);
  if (dtype == dl4j::kBF16)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, dk,
                                          dv, bh, t, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// The bodies a call with this dtype code and head dim takes: 0 the FMA
// bodies, 1 the tensor-core (wgmma) bodies.
extern "C" int dl4j_flash_attn_bwd_body(int dtype, int d) {
  return (int)body_of(dtype, d);
}
