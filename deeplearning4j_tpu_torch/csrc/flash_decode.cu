// Flash decode attention (one query position per row) for Hopper: the slab
// kernel (#3) and the block-paged kernel (#4), each in bf16/f32 and in int8.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py `_flash_decode_kernel`
// (:502, launched by `flash_decode_attention` :645), in its bf16/f32 mode
// and its int8 mode (`kv_scales`, `quantized=True`), called from
// `block_decode` (models/transformer.py:1066) in every decode substep of
// every layer; and `_paged_decode_kernel` (:783, launched by
// `flash_decode_attention_paged` :794), the same math over a block pool.
//
// Inputs: q (B, G, Hkv*K) — the G query heads of each KV head's group,
// packed head-major; pos (B,) int32. The cache is either the WHOLE stacked
// slab (n_layers, 2, B, T, Hkv*K) or the block pool (n_layers, 2, n_blocks,
// bs, Hkv*K) with (B, T/bs) int32 block tables (plane 0 = K, plane 1 = V).
// Layer `layer`'s planes are read in place through strides, never sliced
// into a copy. int8 mode adds per-row f32 scale planes of the same layout
// with a trailing 1. Rows past pos[b] contribute nothing and tiles past it
// are never read.
//
// One body, two row maps: `row_of<PAGED>` turns (layer, plane, b, t) into a
// row of the storage — b*T + t in the slab, tables[b, t/bs]*bs + t%bs in the
// pool — and nothing else differs. The tile is DT = 64 rows in both layouts
// and for any block size (addressing is per row), so the paged kernel over
// a pool is bitwise the slab kernel over the gathered slab by construction.
// The reference tiles its paged kernel at block_size instead: a TPU
// BlockSpec fetches one block per grid step. Block 0 is the all-zero
// sentinel the serving pool maps unallocated table entries to.
//
// bf16/f32 mode, per row b and KV head h:
//   s_t = <q_g, k_t> * scale                   (f32 accumulation), t <= pos[b]
//   o_g = sum_t round_T(exp(s_t - m)) v_t / l  (online softmax, f32)
// int8 mode (the reference's quantized arithmetic, in its order):
//   qsc_g = max(max_j |q[g, j]|, 1e-8) / 127 over ALL heads; qi = rint(q/qsc)
//   s[t, g, h] = float(sum_{j in h} k8[t, j] qi[g, j]) * (ksc[t] * scale) * qsc_g
//   per tile: psc = max(max_{t, g, h} p * vsc[t], 1e-30) / 127 over ALL lanes,
//   p8 = rint(p * vsc / psc), acc = acc * corr + float(sum_t p8 v8) * psc
//   o = acc / max(l, 1e-30), l summing the unquantized p.
//
// Bound on the H100: bytes. A call must read the visible K and V rows of one
// layer (bf16: 2 bytes an element; int8: 1 byte plus a 4-byte scale a row)
// and does a few operations per element, far below the ~295 flop/byte the
// card needs before compute matters.
//
// bf16/f32 design: one block per (KV head, row); one warp per cache row
// reads that head's K segment coalesced and serves all G query rows of the
// group from it (the reference's GQA fold); the V tile is read coalesced by
// threads over the head dim.
//
// int8 design: the p scale spans every head of the tile, so one block must
// cover ALL KV heads of a batch row: the grid is (B,). A warp per (row, head)
// pair forms the score with __dp4a on packed int8 (the int32 sums are exact);
// after a block-wide max, threads own 4 columns each and accumulate the PV
// product in int32 over the tile's rows, reading each V row once as words.
//
// Known limits: the grid is (Hkv, B) blocks in bf16 mode (48 at 8 slots x 6
// heads) and (B,) in int8 mode (8 blocks) on a 132-SM card, so one call
// cannot approach the memory roofline. Splitting T across blocks
// (flash-decoding), and in int8 mode a cluster over the heads sharing the
// tile max through distributed shared memory, are the redesign items.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using dl4j::from_f;
using dl4j::round_t;
using dl4j::to_f;

constexpr int DT = 64;        // cache rows per tile, both modes and layouts
constexpr int NTHREADS = 128; // bf16/f32 mode: four warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXKD = 256;    // head_dim limit (8 elements per lane)
constexpr int GCHUNK = 8;     // query groups accumulated in registers at once
constexpr int NTHREADS8 = 256;  // int8 mode: eight warps per batch row
constexpr int NWARPS8 = NTHREADS8 / 32;
constexpr int MAXGH = 64;     // int8 mode: G * Hkv softmax lanes per block

// Where a cache row lives. Rows are counted in units of Hkv*K elements (the
// scale planes use the same index with a width of 1).
struct RowMap {
  const int* tables;     // paged: (B, bps) block ids; slab: unused
  int bps;               // paged: table entries per batch row
  int bs;                // paged: rows per block
  int t;                 // logical rows per batch row (slab T, paged bps*bs)
  long long plane_rows;  // rows per (layer, plane): slab B*T, paged n_blocks*bs
};

template <bool PAGED>
__device__ __forceinline__ size_t row_of(const RowMap& m, int layer,
                                         int plane, int b, int t) {
  const size_t base = (size_t)(2 * layer + plane) * (size_t)m.plane_rows;
  if (PAGED) {
    const int blk = m.tables[(size_t)b * m.bps + t / m.bs];
    return base + (size_t)blk * m.bs + t % m.bs;
  }
  return base + (size_t)b * m.t + t;
}

__device__ __forceinline__ int warp_sum_int(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int8_t quant8(float x) {
  return (int8_t)(int)fminf(fmaxf(rintf(x), -127.f), 127.f);
}

// ---- bf16/f32 mode -----------------------------------------------------------

inline size_t smem_bytes(int g, int kd) {
  // q and accumulator (G x kd each), score tile (G x DT), m / l / corr
  return sizeof(float) * ((size_t)2 * g * kd + (size_t)g * DT + 3 * (size_t)g);
}

template <typename T, bool PAGED>
__global__ void __launch_bounds__(NTHREADS)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ cache,
                        const int* __restrict__ pos, T* __restrict__ out,
                        RowMap map, int G, int hkv, int kd, int layer,
                        float scale) {
  extern __shared__ float sm[];
  __shared__ size_t koff[DT], voff[DT];
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
  const int n_rows = min(pos[b] + 1, map.t);
  const int nk = (kd + 31) / 32;

  for (int t0 = 0; t0 < n_rows; t0 += DT) {
    const int rows = min(DT, n_rows - t0);
    if (tid < rows) {
      koff[tid] = row_of<PAGED>(map, layer, 0, b, t0 + tid) * hk + h * kd;
      voff[tid] = row_of<PAGED>(map, layer, 1, b, t0 + tid) * hk + h * kd;
    }
    __syncthreads();
    // scores: warp w owns cache rows w, w + 4, ...; lanes split the head dim
    for (int r = warp; r < DT; r += NWARPS) {
      if (r < rows) {
        const T* krow = cache + koff[r];
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
          const float vv = to_f(cache[voff[r] + d]);
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

template <typename T, bool PAGED>
cudaError_t launch(const void* q, const void* cache, const int* pos,
                   void* out, const RowMap& map, int B, int G, int hkv,
                   int kd, int layer, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, kd);
  cudaError_t err = dl4j::allow_smem(flash_decode_kernel<T, PAGED>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(hkv, B);
  flash_decode_kernel<T, PAGED><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(cache), pos,
      static_cast<T*>(out), map, G, hkv, kd, layer, scale);
  return cudaGetLastError();
}

// ---- int8 mode ---------------------------------------------------------------

inline size_t smem_bytes_int8(int g, int hkv, int kd) {
  const size_t hk = (size_t)hkv * kd, gh = (size_t)g * hkv;
  // acc (G x hk f32), p tile (gh x DT f32), m / l / corr (gh), q scales (G),
  // block-max scratch, packed q (G x hk int8), quantized p tile (gh x DT)
  return sizeof(float) * (g * hk + gh * DT + 3 * gh + g + NWARPS8) +
         g * hk + gh * DT;
}

template <typename TQ, bool PAGED>
__global__ void __launch_bounds__(NTHREADS8)
    flash_decode_int8_kernel(const TQ* __restrict__ q,
                             const int8_t* __restrict__ cache,
                             const float* __restrict__ scales,
                             const int* __restrict__ pos, TQ* __restrict__ out,
                             RowMap map, int G, int hkv, int kd, int layer,
                             float scale) {
  extern __shared__ float sm[];
  __shared__ size_t koff[DT], voff[DT];
  __shared__ float ksc_s[DT], vsc_s[DT];
  __shared__ float psc_s;
  const int b = blockIdx.x;
  const int hk = hkv * kd, gh = G * hkv, hk4 = hk / 4, kd4 = kd / 4;
  float* acc = sm;
  float* p_s = acc + G * hk;
  float* m_s = p_s + gh * DT;
  float* l_s = m_s + gh;
  float* c_s = l_s + gh;
  float* qsc_s = c_s + gh;
  float* red_s = qsc_s + G;
  int* q8 = reinterpret_cast<int*>(red_s + NWARPS8);  // G x hk4 packed words
  int8_t* p8 = reinterpret_cast<int8_t*>(q8 + G * hk4);  // gh x DT
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const TQ* qb = q + (size_t)b * G * hk;

  // q quantization: one scale per group over all heads
  for (int g = warp; g < G; g += NWARPS8) {
    float mx = 0.f;
    for (int j = lane; j < hk; j += 32)
      mx = fmaxf(mx, fabsf(to_f(qb[(size_t)g * hk + j])));
    mx = dl4j::warp_max(mx);
    if (lane == 0) qsc_s[g] = fmaxf(mx, 1e-8f) / 127.f;
  }
  for (int i = tid; i < G * hk; i += NTHREADS8) acc[i] = 0.f;
  for (int i = tid; i < gh; i += NTHREADS8) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < G * hk4; i += NTHREADS8) {
    const int g = i / hk4, w = i % hk4;
    const float sc = qsc_s[g];
    unsigned word = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int8_t v = quant8(to_f(qb[(size_t)g * hk + 4 * w + e]) / sc);
      word |= (unsigned)(uint8_t)v << (8 * e);
    }
    q8[i] = (int)word;
  }
  const int n_rows = min(pos[b] + 1, map.t);

  for (int t0 = 0; t0 < n_rows; t0 += DT) {
    const int rows = min(DT, n_rows - t0);
    if (tid < rows) {
      const size_t kr = row_of<PAGED>(map, layer, 0, b, t0 + tid);
      const size_t vr = row_of<PAGED>(map, layer, 1, b, t0 + tid);
      koff[tid] = kr * hk;
      voff[tid] = vr * hk;
      ksc_s[tid] = scales[kr] * scale;
      vsc_s[tid] = scales[vr];
    }
    __syncthreads();

    // scores: a warp per (row, head) pair, int8 dot products on __dp4a
    for (int pr = warp; pr < DT * hkv; pr += NWARPS8) {
      const int r = pr / hkv, h = pr % hkv;
      if (r < rows) {
        const int* krow =
            reinterpret_cast<const int*>(cache + koff[r] + (size_t)h * kd);
        const int k0 = lane < kd4 ? krow[lane] : 0;
        const int k1 = lane + 32 < kd4 ? krow[lane + 32] : 0;
        for (int g = 0; g < G; ++g) {
          const int* qg = q8 + g * hk4 + h * kd4;
          int part = 0;
          if (lane < kd4) part = __dp4a(k0, qg[lane], part);
          if (lane + 32 < kd4) part = __dp4a(k1, qg[lane + 32], part);
          part = warp_sum_int(part);
          if (lane == 0)
            p_s[(g * hkv + h) * DT + r] = (float)part * ksc_s[r] * qsc_s[g];
        }
      } else if (lane == 0) {
        for (int g = 0; g < G; ++g) p_s[(g * hkv + h) * DT + r] = -INFINITY;
      }
    }
    __syncthreads();

    // online softmax per (g, h) lane (every tile holds >= 1 visible row)
    for (int ln = warp; ln < gh; ln += NWARPS8) {
      float* srow = p_s + ln * DT;
      float mx = -INFINITY;
      for (int c = lane; c < DT; c += 32) mx = fmaxf(mx, srow[c]);
      mx = dl4j::warp_max(mx);
      const float m_prev = m_s[ln];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < DT; c += 32) {
        const float p = expf(srow[c] - m_new);
        sum += p;
        srow[c] = p;
      }
      sum = dl4j::warp_sum(sum);
      if (lane == 0) {
        const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
        // _rn intrinsics: rounded as the reference rounds (no contraction)
        l_s[ln] = __fadd_rn(__fmul_rn(corr, l_s[ln]), sum);
        m_s[ln] = m_new;
        c_s[ln] = corr;
      }
    }
    __syncthreads();

    // one p scale for the whole tile: max of p * vsc over every row and lane
    float mx = 0.f;
    for (int i = tid; i < gh * DT; i += NTHREADS8) {
      const int r = i % DT;
      if (r < rows) mx = fmaxf(mx, p_s[i] * vsc_s[r]);
    }
    mx = dl4j::warp_max(mx);
    if (lane == 0) red_s[warp] = mx;
    __syncthreads();
    if (tid == 0) {
      float m = red_s[0];
      for (int w = 1; w < NWARPS8; ++w) m = fmaxf(m, red_s[w]);
      psc_s = fmaxf(m, 1e-30f) / 127.f;
    }
    __syncthreads();
    const float psc = psc_s;
    for (int i = tid; i < gh * DT; i += NTHREADS8) {
      const int r = i % DT;
      p8[i] = r < rows ? quant8(p_s[i] * vsc_s[r] / psc) : (int8_t)0;
    }
    __syncthreads();

    // PV: a thread owns 4 columns (one word of every V row), int32 sums
    for (int w = tid; w < hk4; w += NTHREADS8) {
      const int h = (4 * w) / kd;
      for (int g0 = 0; g0 < G; g0 += GCHUNK) {
        const int ng = min(GCHUNK, G - g0);
        int a[GCHUNK][4];
#pragma unroll
        for (int j = 0; j < GCHUNK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[j][e] = 0;
        for (int r = 0; r < rows; ++r) {
          const int vw =
              *reinterpret_cast<const int*>(cache + voff[r] + 4 * w);
#pragma unroll
          for (int j = 0; j < GCHUNK; ++j) {
            if (j < ng) {
              const int pr = p8[((g0 + j) * hkv + h) * DT + r];
#pragma unroll
              for (int e = 0; e < 4; ++e)
                a[j][e] += pr * (int)(int8_t)(vw >> (8 * e));
            }
          }
        }
#pragma unroll
        for (int j = 0; j < GCHUNK; ++j) {
          if (j < ng) {
            const int g = g0 + j;
            const float corr = c_s[g * hkv + h];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float* ac = acc + (size_t)g * hk + 4 * w + e;
              *ac = __fadd_rn(__fmul_rn(*ac, corr),
                              __fmul_rn((float)a[j][e], psc));
            }
          }
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < G * hk; i += NTHREADS8) {
    const int g = i / hk, h = (i % hk) / kd;
    const float l = fmaxf(l_s[g * hkv + h], 1e-30f);
    out[(size_t)b * G * hk + i] = from_f<TQ>(acc[i] / l);
  }
}

template <typename TQ, bool PAGED>
cudaError_t launch_int8(const void* q, const void* cache, const float* scales,
                        const int* pos, void* out, const RowMap& map, int B,
                        int G, int hkv, int kd, int layer, float scale,
                        cudaStream_t stream) {
  const size_t smem = smem_bytes_int8(G, hkv, kd);
  cudaError_t err =
      dl4j::allow_smem(flash_decode_int8_kernel<TQ, PAGED>, smem);
  if (err != cudaSuccess) return err;
  flash_decode_int8_kernel<TQ, PAGED><<<B, NTHREADS8, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(cache), scales,
      pos, static_cast<TQ*>(out), map, G, hkv, kd, layer, scale);
  return cudaGetLastError();
}

template <bool PAGED>
int dispatch(const void* q, const void* cache, const void* scales,
             const int* pos, void* out, const RowMap& map, int B, int G,
             int hkv, int kd, int layer, float scale, int dtype, int int8,
             cudaStream_t s) {
  if (B <= 0 || G <= 0 || hkv <= 0 || kd <= 0 || kd > MAXKD || map.t <= 0)
    return (int)cudaErrorInvalidValue;
  if (int8) {
    if (kd % 4 || G * hkv > MAXGH || scales == nullptr)
      return (int)cudaErrorInvalidValue;
    const float* sc = static_cast<const float*>(scales);
    if (dtype == dl4j::kF32)
      return (int)launch_int8<float, PAGED>(q, cache, sc, pos, out, map, B, G,
                                            hkv, kd, layer, scale, s);
    if (dtype == dl4j::kBF16)
      return (int)launch_int8<__nv_bfloat16, PAGED>(
          q, cache, sc, pos, out, map, B, G, hkv, kd, layer, scale, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == dl4j::kF32)
    return (int)launch<float, PAGED>(q, cache, pos, out, map, B, G, hkv, kd,
                                     layer, scale, s);
  if (dtype == dl4j::kBF16)
    return (int)launch<__nv_bfloat16, PAGED>(q, cache, pos, out, map, B, G,
                                             hkv, kd, layer, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The tile (cache rows per online-softmax step) this library was built for:
// in int8 mode it is part of the function (the p scale is per tile).
extern "C" int dl4j_flash_decode_tile() { return DT; }

// Slab kernel #3. q, out: (B, G, hkv*kd) in `dtype`; cache: (n_layers, 2, B,
// t, hkv*kd) contiguous, in `dtype`, or int8 with `int8` set and `scales`
// (n_layers, 2, B, t, 1) f32; pos: (B,) int32 on the device. Returns
// cudaGetLastError().
extern "C" int dl4j_flash_decode(const void* q, const void* cache,
                                 const void* scales, const void* pos,
                                 void* out, int B, int G, int hkv, int kd,
                                 int t, int layer, float scale, int dtype,
                                 int int8, void* stream) {
  RowMap map{nullptr, 0, 0, t, (long long)B * t};
  return dispatch<false>(q, cache, scales, static_cast<const int*>(pos), out,
                         map, B, G, hkv, kd, layer, scale, dtype, int8,
                         static_cast<cudaStream_t>(stream));
}

// Paged kernel #4. blocks: (n_layers, 2, n_blocks, bs, hkv*kd) (scales:
// (n_layers, 2, n_blocks, bs, 1) f32 in int8 mode); tables: (B, bps) int32
// block ids on the device; everything else as dl4j_flash_decode.
extern "C" int dl4j_flash_decode_paged(const void* q, const void* blocks,
                                       const void* scales, const void* tables,
                                       const void* pos, void* out, int B,
                                       int G, int hkv, int kd, int n_blocks,
                                       int bs, int bps, int layer, float scale,
                                       int dtype, int int8, void* stream) {
  if (bs <= 0 || bps <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  RowMap map{static_cast<const int*>(tables), bps, bs, bps * bs,
             (long long)n_blocks * bs};
  return dispatch<true>(q, blocks, scales, static_cast<const int*>(pos), out,
                        map, B, G, hkv, kd, layer, scale, dtype, int8,
                        static_cast<cudaStream_t>(stream));
}
