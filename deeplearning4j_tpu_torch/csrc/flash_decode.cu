// Flash decode attention (one query position per row) for Hopper: the slab
// kernel (#3) and the block-paged kernel (#4), each in bf16/f32 and in int8.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py `_flash_decode_kernel`
// (:502, launched by `flash_decode_attention` :645) in its bf16/f32 mode
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
// with a trailing 1. Rows past pos[b] are never read.
//
// One body, two row maps: `row_of<PAGED>` turns (layer, plane, b, t) into a
// row of the storage — b*T + t in the slab, tables[b, t/bs]*bs + t%bs in the
// pool — and nothing else differs. Every boundary (split, tile, ring stage)
// is a function of pos[b] and block_t alone, never of B, T, the layout or
// the grid, so a row decodes bitwise the same at any batch size and the
// paged kernel over a pool is bitwise the slab kernel over the gathered
// slab. Block 0 is the all-zero sentinel the serving pool maps unallocated
// table entries to.
//
// bf16/f32 mode, per row b and KV head h (block_t changes nothing here):
//   s_t = <q_g, k_t> * scale                   (f32 accumulation), t <= pos[b]
//   o_g = sum_t round_T(exp(s_t - m)) v_t / l  (online softmax, f32)
// int8 mode (the reference's quantized arithmetic, in its order), over
// tiles of block_t rows:
//   qsc_g = max(max_j |q[g, j]|, 1e-8) / 127 over ALL heads; qi = rint(q/qsc)
//   s[t, g, h] = float(sum_{j in h} k8[t, j] qi[g, j]) * (ksc[t] * scale) * qsc_g
//   per tile: m per (g, h) lane, p = exp(s - m),
//   psc = max(max_{t, g, h} p * vsc[t], 1e-30) / 127 over ALL rows and lanes,
//   p8 = rint(p * vsc / psc), acc = acc * corr + float(sum_t p8 v8) * psc
//   o = acc / max(l, 1e-30), l summing the unquantized p.
//
// Bound on the H100: bytes. A call must read the visible K and V rows of one
// layer (bf16: 2 bytes an element; int8: 1 byte plus a 4-byte scale a row)
// and does a few operations per byte, far below the ~295 flop/byte the card
// needs before compute matters. The design keeps bytes in flight on many
// SMs: every block streams its rows into shared memory through a ring of
// `cp.async` stages (16-byte copies where the layout allows), the next
// stages in flight while this one is computed. Paged, a block first stages
// its batch row's table row into shared memory beside the pos[b] load, so
// no copy waits on a table read.
//
// bf16/f32 design (flash-decoding): a thread-block cluster of SPLITS blocks
// per (row, KV head), grid (SPLITS, Hkv, B). Block s takes rows
// [s*c, min((s+1)*c, n)) of the row's n = pos[b] + 1 visible rows, c = n /
// SPLITS rounded up to 8, runs the online softmax over them in TR-row ring
// stages (a warp per cache row serves all G query rows of the group, the
// reference's GQA fold), and leaves (m, l, acc) in shared memory. After a
// cluster barrier each block combines one slice of the G*K outputs from
// every block's partials through distributed shared memory, in rank order:
// no scratch, no second kernel, no atomics.
//
// int8 design: the p scale spans every head and row of a tile, so one
// cluster of CL8 blocks serves a batch row, grid (CL8, B); block j takes
// rows [t0 + j*c, ...) of each tile (c = tile rows / CL8 rounded up to 8)
// over all heads. Per tile: scores on __dp4a (a thread per (row, head)),
// kept in shared memory, or where a tile's rows do not fit there in a
// scratch tensor the wrapper allocates; exchange 1, the per-lane maxima;
// p and p * vsc; exchange 2, the block maxima of p * vsc and the partial
// l sums (added in rank order); int32 P V sums over the block's rows;
// exchange 3, the int32 partials, which add exactly in any order; block j
// then updates its slice of acc with the `_rn` operations in the
// reference's order. Every exchange goes through distributed shared memory.
//
// Cluster sizes: 8 blocks in both modes. 16 (a non-portable cluster) was
// slower at the serving shape and doubled a one-row call's fixed cost, 4
// was slower too (scripts/torch_decode_sweep.py times the three).

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using dl4j::from_f;
using dl4j::round_t;
using dl4j::to_f;

constexpr int SPLITS = 8;     // bf16/f32: blocks (one cluster) per (row, head)
constexpr int TR = 32;        // bf16/f32: cache rows per ring stage
constexpr int NST = 3;        // bf16/f32: ring stages
constexpr int NTHREADS = 128; // bf16/f32: four warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAXKD = 256;    // head_dim limit
constexpr int CL8 = 8;        // int8: blocks (one cluster) per batch row
constexpr int NST8 = 4;       // int8: ring stages
constexpr int STAGE8 = 32768; // int8: cache bytes per ring stage (at most)
constexpr int SCORES8 = 32768;  // int8: score bytes kept in shared memory
constexpr int NTHREADS8 = 256;
// int8: blocks an SM must hold. Its ring alone takes most of the shared
// memory, so one; stated, because without it ptxas capped the kernel at 128
// registers (room for two blocks) and spilled
constexpr int MINB8 = 1;
constexpr int NWARPS8 = NTHREADS8 / 32;
constexpr int MAXGH = 64;     // int8 mode: G * Hkv softmax lanes
static_assert(TR == 32, "the softmax gives each lane one row of a stage");

// Where a cache row lives. Rows are counted in units of Hkv*K elements (the
// scale planes use the same index with a width of 1).
struct RowMap {
  const int* tables;     // paged: (B, bps) block ids; slab: unused
  int bps;               // paged: table entries per batch row
  int bs;                // paged: rows per block
  int bs_shift;          // paged: log2(bs) when bs is a power of 2, else -1
  int t;                 // logical rows per batch row (slab T, paged bps*bs)
  long long plane_rows;  // rows per (layer, plane): slab B*T, paged n_blocks*bs
};

// `tab`: paged, batch row b's table entries, staged in shared memory
template <bool PAGED>
__device__ __forceinline__ size_t row_of(const RowMap& m, const int* tab,
                                         int layer, int plane, int b, int t) {
  const size_t base = (size_t)(2 * layer + plane) * (size_t)m.plane_rows;
  if (PAGED) {
    if (m.bs_shift >= 0)
      return base + ((size_t)tab[t >> m.bs_shift] << m.bs_shift) +
             (t & (m.bs - 1));
    return base + (size_t)tab[t / m.bs] * m.bs + t % m.bs;
  }
  return base + (size_t)b * m.t + t;
}

// paged: stage batch row b's whole table row into shared memory (its loads
// in flight beside pos[b]'s, so no table read waits on pos or sits on a
// copy's path); the caller synchronizes before use
template <bool PAGED>
__device__ __forceinline__ void stage_table(const RowMap& m, int* tab, int b,
                                            int tid, int nthreads) {
  if (PAGED)
    for (int i = tid; i < m.bps; i += nthreads)
      tab[i] = m.tables[(size_t)b * m.bps + i];
}

// rows per part when n visible rows are cut into `parts` runs: a multiple
// of 8, a function of n alone
__device__ __forceinline__ int part_rows(int n, int parts) {
  const int c = (max(n, 0) + parts - 1) / parts;
  return (c + 7) & ~7;
}

// an asynchronous global -> shared copy of `gran` bytes (16, 8 or 4; 2 is a
// plain copy, for bf16 rows that are not 4-byte aligned)
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int gran) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (gran == 16)
    asm volatile("cp.async.cg.shared::cta.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (gran == 8)
    asm volatile("cp.async.ca.shared::cta.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src) : "memory");
  else if (gran == 4)
    asm volatile("cp.async.ca.shared::cta.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
  else
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
}

// lanes per row of a copy loop: the smallest power of 2 >= min(copies a
// row, 16), as its log2; a warp then serves 32 >> it rows at once
__device__ __forceinline__ int lanes_log2(int copies) {
  int l = 0;
  while (l < 4 && (1 << l) < copies) ++l;
  return l;
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ int8_t quant8(float x) {
  return (int8_t)(int)fminf(fmaxf(rintf(x), -127.f), 127.f);
}

__host__ __device__ inline size_t up16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// ---- bf16/f32 mode -----------------------------------------------------------

inline size_t smem_bytes(int g, int kd, int esz, int tab_ints) {
  // ring (NST stages of TR K rows and TR V rows of one head), q and acc
  // (G x kd each), score tile (G x TR), m / l / corr, paged: the table row
  return up16((size_t)NST * 2 * TR * kd * esz) +
         sizeof(float) * ((size_t)2 * g * kd + (size_t)g * TR + 3 * (size_t)g) +
         sizeof(int) * (size_t)tab_ints;
}

template <typename T, bool PAGED>
__global__ void __launch_bounds__(NTHREADS, 4)
    flash_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ cache,
                              const int* __restrict__ pos,
                              T* __restrict__ out, RowMap map, int G, int hkv,
                              int kd, int layer, float scale, int gran) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = hkv * kd;
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(
      smem + up16((size_t)NST * 2 * TR * kd * sizeof(T)));
  float* acc = q_s + G * kd;
  float* s_s = acc + G * kd;
  float* m_s = s_s + G * TR;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  int* tab_s = reinterpret_cast<int*>(c_s + G);  // paged: the table row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_table<PAGED>(map, tab_s, b, tid, NTHREADS);
  const int n = min(pos[b] + 1, map.t);
  if (PAGED) __syncthreads();
  const int c = part_rows(n, SPLITS);
  const int r0 = min(split * c, max(n, 0));
  const int r1 = min(r0 + c, n);
  const int nsub = (max(r1 - r0, 0) + TR - 1) / TR;
  const int cpr = kd * (int)sizeof(T) / gran;  // copies per head row
  const int ll = lanes_log2(cpr);

  // stage i of the ring: K and V head rows [r0 + i*TR, ...)
  auto fetch = [&](int i) {
    if (i < nsub) {
      const int t0 = r0 + i * TR, nr = min(TR, r1 - t0);
      T* st = ring + (size_t)(i % NST) * 2 * TR * kd;
      // 2^ll lanes per (plane, row): one address, the lanes over its copies
      for (int pr = (warp << (5 - ll)) + (lane >> ll); pr < 2 * nr;
           pr += NWARPS << (5 - ll)) {
        const int plane = pr >= nr, r = pr - plane * nr;
        const size_t row = row_of<PAGED>(map, tab_s, layer, plane, b, t0 + r);
        const char* src =
            reinterpret_cast<const char*>(cache + row * hk + (size_t)h * kd);
        char* dst = reinterpret_cast<char*>(st + ((size_t)plane * TR + r) * kd);
        for (int ch = lane & ((1 << ll) - 1); ch < cpr; ch += 1 << ll)
          cp_async(dst + ch * gran, src + ch * gran, gran);
      }
    }
    cp_commit();
  };
#pragma unroll
  for (int i = 0; i < NST - 1; ++i) fetch(i);

  for (int i = tid; i < G * kd; i += NTHREADS) {
    const int g = i / kd, d = i % kd;
    q_s[i] = to_f(q[((size_t)b * G + g) * hk + (size_t)h * kd + d]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += NTHREADS) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  constexpr int RPW = TR / NWARPS;  // stage rows per warp

  for (int i = 0; i < nsub; ++i) {
    fetch(i + NST - 1);
    cp_wait<NST - 1>();
    __syncthreads();
    const T* kt = ring + (size_t)(i % NST) * 2 * TR * kd;
    const T* vt = kt + (size_t)TR * kd;
    const int rows = min(TR, r1 - (r0 + i * TR));
    // scores: warp w owns stage rows w, w + 4, ...; lanes split the head
    // dim; the warp's rows are reduced together (independent shuffles)
    for (int g = 0; g < G; ++g) {
      const float* qg = q_s + g * kd;
      float part[RPW];
#pragma unroll
      for (int k = 0; k < RPW; ++k) part[k] = 0.f;
      for (int d = lane; d < kd; d += 32) {
        const float qd = qg[d];
#pragma unroll
        for (int k = 0; k < RPW; ++k) {
          const int r = warp + NWARPS * k;
          if (r < rows)
            part[k] = fmaf(qd, to_f(kt[(size_t)r * kd + d]), part[k]);
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < RPW; ++k)
          part[k] += __shfl_xor_sync(0xffffffffu, part[k], o);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < RPW; ++k) {
          const int r = warp + NWARPS * k;
          s_s[g * TR + r] = r < rows ? part[k] * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // online softmax per query row g (every stage holds >= 1 visible row)
    for (int g = warp; g < G; g += NWARPS) {
      float* srow = s_s + g * TR;
      const float sv = srow[lane];
      const float mx = dl4j::warp_max(sv);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(sv - m_new);
      srow[lane] = round_t<T>(p);  // PV operand in the value dtype
      const float sum = dl4j::warp_sum(p);
      if (lane == 0) {
        const float corr = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
        l_s[g] = corr * l_s[g] + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // PV: threads own head-dim columns, one query row at a time
    for (int d = tid; d < kd; d += NTHREADS) {
      for (int g = 0; g < G; ++g) {
        const float* pg = s_s + g * TR;
        float a = acc[g * kd + d] * c_s[g];
        for (int r = 0; r < rows; ++r)
          a = fmaf(pg[r], to_f(vt[(size_t)r * kd + d]), a);
        acc[g * kd + d] = a;
      }
    }
    __syncthreads();
  }
  cp_wait<0>();

  // combine: block `split` writes outputs [e0, e1) of the G*kd from every
  // block's (m, l, acc), read through distributed shared memory (all loads
  // of a kind started together) and added in rank order
  cluster.sync();
  const int per = (G * kd + SPLITS - 1) / SPLITS;
  const int e0 = split * per, e1 = min(e0 + per, G * kd);
  for (int i = e0 + tid; i < e1; i += NTHREADS) {
    const int g = i / kd, d = i % kd;
    float ms[SPLITS], ls[SPLITS], as[SPLITS];
#pragma unroll
    for (int s = 0; s < SPLITS; ++s) {
      ms[s] = cluster.map_shared_rank(m_s, s)[g];
      ls[s] = cluster.map_shared_rank(l_s, s)[g];
      as[s] = cluster.map_shared_rank(acc, s)[i];
    }
    float mx = -INFINITY;
#pragma unroll
    for (int s = 0; s < SPLITS; ++s) mx = fmaxf(mx, ms[s]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int s = 0; s < SPLITS; ++s) {
      if (ms[s] == -INFINITY) continue;  // no visible rows in that split
      const float w = expf(ms[s] - mx);
      l += ls[s] * w;
      o += as[s] * w;
    }
    out[((size_t)b * G + g) * hk + (size_t)h * kd + d] =
        from_f<T>(o / fmaxf(l, 1e-30f));
  }
  cluster.sync();  // every block's partials stay alive until all have read
}

// grid (x, y, z) and cluster (x, y, z) of this thread's last launch, as
// passed to cudaLaunchKernelEx (dl4j_flash_decode_last_launch reads it)
thread_local int last_launch[6] = {0, 0, 0, 0, 0, 0};

// A cluster launch (cluster of `cx` blocks along x) through
// cudaLaunchKernelEx; clusters above 8 blocks are opted in as non-portable.
template <typename... P, typename... A>
cudaError_t launch_cluster(void (*kernel)(P...), dim3 grid, int threads,
                           size_t smem, int cx, cudaStream_t stream,
                           A... args) {
  cudaError_t err = dl4j::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  if (cx > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cx;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err == cudaSuccess) {
    const int dims[6] = {(int)grid.x, (int)grid.y, (int)grid.z, cx, 1, 1};
    for (int i = 0; i < 6; ++i) last_launch[i] = dims[i];
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the widest copy (16, 8, 4 or 2 bytes) that every row start, head offset
// and the base pointer allow, for rows of `row_bytes` and heads of
// `head_bytes`
inline int granule(const void* base, size_t row_bytes, size_t head_bytes) {
  const size_t a = (size_t)base | row_bytes | head_bytes;
  for (int g = 16; g >= 4; g /= 2)
    if (a % g == 0) return g;
  return 2;
}

template <typename T, bool PAGED>
cudaError_t launch(const void* q, const void* cache, const int* pos,
                   void* out, const RowMap& map, int B, int G, int hkv,
                   int kd, int layer, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(G, kd, sizeof(T), PAGED ? map.bps : 0);
  const int gran = granule(cache, (size_t)hkv * kd * sizeof(T),
                           (size_t)kd * sizeof(T));
  return launch_cluster(flash_decode_split_kernel<T, PAGED>,
                        dim3(SPLITS, hkv, B), NTHREADS, smem, SPLITS, stream,
                        static_cast<const T*>(q), static_cast<const T*>(cache),
                        pos, static_cast<T*>(out), map, G, hkv, kd, layer,
                        scale, gran);
}

// ---- int8 mode ---------------------------------------------------------------

// rows of one ring stage: at most STAGE8 bytes of cache rows, 1..64 rows
__host__ __device__ inline int stage_rows8(int hk) {
  const int r = STAGE8 / hk;
  return r < 1 ? 1 : (r > 64 ? 64 : r);
}

struct Int8Layout {
  size_t stage, ring, q8, ipart, acc, p8, sc, total;
};

// rows of a tile one int8 block takes at most (tiles of block_t rows of a
// t-row cache), and whether their scores (gh + 1 floats a row: the lanes,
// then the row's V scale) fit in shared memory; else they go to the
// wrapper's scratch tensor
__host__ __device__ inline int block_rows8(int block_t, int t) {
  const int n = block_t < t ? block_t : t;
  return ((n + CL8 - 1) / CL8 + 7) & ~7;
}
__host__ __device__ inline bool smem_scores8(int g, int hkv, int block_t,
                                             int t) {
  return (size_t)block_rows8(block_t, t) * (g * hkv + 1) * 4 <= SCORES8;
}

// shared memory of the int8 kernel: the ring (per stage RS rows of hk bytes,
// then 2 f32 scales a row), packed q (G x hk int8), int32 P V partials
// (G x hk), this block's slice of acc, the stage's p8 (RS x gh), the scores
// of the block's rows of a tile (when they fit), the lane state (m, l,
// corr, lane max, lane sum: 5 x gh), q scales (G), block-max scratch, the
// block's max of p * vsc, and (paged) the table row
__host__ __device__ inline Int8Layout int8_layout(int g, int hkv, int kd,
                                                  int block_t, int t,
                                                  int tab_ints) {
  const size_t hk = (size_t)hkv * kd, gh = (size_t)g * hkv;
  const int rs = stage_rows8((int)hk);
  Int8Layout L;
  L.stage = up16(rs * hk + 8 * (size_t)rs);
  L.ring = NST8 * L.stage;
  L.q8 = up16(g * hk);
  L.ipart = 4 * g * hk;
  L.acc = up16(4 * ((g * hk + CL8 - 1) / CL8));
  L.p8 = up16(rs * gh);
  L.sc = smem_scores8(g, hkv, block_t, t)
             ? up16((size_t)block_rows8(block_t, t) * (gh + 1) * 4)
             : 0;
  L.total = L.ring + L.q8 + L.ipart + L.acc + L.p8 + L.sc +
            4 * (5 * gh + g + NWARPS8 + 1 + (size_t)tab_ints);
  return L;
}

template <typename TQ, bool PAGED>
__global__ void __launch_bounds__(NTHREADS8, MINB8)
    flash_decode_int8_cluster_kernel(
        const TQ* __restrict__ q, const int8_t* __restrict__ cache,
        const float* __restrict__ scales, const int* __restrict__ pos,
        float* __restrict__ scr, TQ* __restrict__ out, RowMap map, int G,
        int hkv, int kd, int layer, float scale, int block_t, int gran) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.y;
  const int hk = hkv * kd, gh = G * hkv, hk4 = hk / 4, kd4 = kd / 4;
  const Int8Layout L =
      int8_layout(G, hkv, kd, block_t, map.t, PAGED ? map.bps : 0);
  const int rs = stage_rows8(hk);
  unsigned char* ring = smem;
  int* q8 = reinterpret_cast<int*>(smem + L.ring);  // G x hk4 packed words
  int* ipart = reinterpret_cast<int*>(smem + L.ring + L.q8);
  float* acc = reinterpret_cast<float*>(smem + L.ring + L.q8 + L.ipart);
  int8_t* p8s =
      reinterpret_cast<int8_t*>(smem + L.ring + L.q8 + L.ipart + L.acc);
  float* sc_s = reinterpret_cast<float*>(smem + L.ring + L.q8 + L.ipart +
                                         L.acc + L.p8);
  float* m_s = reinterpret_cast<float*>(smem + L.ring + L.q8 + L.ipart +
                                        L.acc + L.p8 + L.sc);
  float* l_s = m_s + gh;
  float* c_s = l_s + gh;
  float* xm_s = c_s + gh;  // this block's lane maxima (exchange 1)
  float* ls_s = xm_s + gh; // this block's lane sums of p (exchange 2)
  float* qsc_s = ls_s + gh;
  float* red_s = qsc_s + G;
  float* pm_s = red_s + NWARPS8;  // this block's max of p * vsc (exchange 2)
  int* tab_s = reinterpret_cast<int*>(pm_s + 1);  // paged: the table row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const TQ* qb = q + (size_t)b * G * hk;
  stage_table<PAGED>(map, tab_s, b, tid, NTHREADS8);
  const int n = min(pos[b] + 1, map.t);
  // the scores of this block's rows of a tile, a row of gh + 1 floats: in
  // shared memory (indexed from the block's first row of the tile) or in
  // the scratch tensor (indexed from row 0 of batch row b)
  const bool in_smem = L.sc != 0;
  float* sbuf = in_smem ? sc_s : scr + (size_t)b * map.t * (gh + 1);
  const int per = (G * hk + CL8 - 1) / CL8;  // this block's acc slice
  const int e0 = rank * per, e1 = min(e0 + per, G * hk);
  const int cpr = hk / gran;  // copies per cache row
  const int ll = lanes_log2(cpr);

  for (int i = tid; i < e1 - e0; i += NTHREADS8) acc[i] = 0.f;
  for (int i = tid; i < gh; i += NTHREADS8) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }
  if (PAGED) __syncthreads();  // the table row, before the first copy

  for (int t0 = 0; t0 < n; t0 += block_t) {
    const int tn = min(block_t, n - t0);  // visible rows of the tile
    const int c = part_rows(tn, CL8);
    const int r0 = t0 + min(rank * c, tn), r1 = min(r0 + c, t0 + tn);
    const int rows = max(r1 - r0, 0);
    const int sbase = in_smem ? r0 : 0;
    const int nsub = (rows + rs - 1) / rs;
    const int total = 2 * nsub;  // K stages, then V stages
    for (int i = tid; i < G * hk; i += NTHREADS8) ipart[i] = 0;

    // ring item i: the K rows (i < nsub, with both rows' scales) or the V
    // rows of stage i % nsub of this block's rows
    auto fetch = [&](int i) {
      if (i < total) {
        const int plane = i >= nsub, si = i - plane * nsub;
        const int ts = r0 + si * rs, nr = min(rs, r1 - ts);
        unsigned char* st = ring + (size_t)(i % NST8) * L.stage;
        // 2^ll lanes per row: one address, the lanes over its copies
        for (int r = (warp << (5 - ll)) + (lane >> ll); r < nr;
             r += NWARPS8 << (5 - ll)) {
          const size_t row = row_of<PAGED>(map, tab_s, layer, plane, b, ts + r);
          for (int ch = lane & ((1 << ll) - 1); ch < cpr; ch += 1 << ll)
            cp_async(st + (size_t)r * hk + ch * gran,
                     cache + row * hk + (size_t)ch * gran, gran);
        }
        if (!plane) {
          float* sc = reinterpret_cast<float*>(st + (size_t)rs * hk);
          for (int idx = tid; idx < 2 * nr; idx += NTHREADS8)
            cp_async(sc + idx,
                     scales + row_of<PAGED>(map, tab_s, layer, idx & 1, b,
                                            ts + (idx >> 1)),
                     4);
        }
      }
      cp_commit();
    };
#pragma unroll
    for (int i = 0; i < NST8 - 1; ++i) fetch(i);
    if (t0 == 0) {
      // q quantization (while the first rows are in flight): one scale per
      // group over all heads
      for (int g = warp; g < G; g += NWARPS8) {
        float mx = 0.f;
        for (int j = lane; j < hk; j += 32)
          mx = fmaxf(mx, fabsf(to_f(qb[(size_t)g * hk + j])));
        mx = dl4j::warp_max(mx);
        if (lane == 0) qsc_s[g] = fmaxf(mx, 1e-8f) / 127.f;
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
    }

    float psc = 0.f;
    for (int i = 0; i <= total; ++i) {
      if (i == nsub) {
        // -- exchange 1: every block's lane maxima -> m_new, corr
        __syncthreads();
        for (int ln = warp; ln < gh; ln += NWARPS8) {
          float mx = -INFINITY;
          for (int r = lane; r < rows; r += 32)
            mx = fmaxf(mx, sbuf[(size_t)(r0 + r - sbase) * (gh + 1) + ln]);
          mx = dl4j::warp_max(mx);
          if (lane == 0) xm_s[ln] = mx;
        }
        cluster.sync();
        if (tid < gh) {
          float xs[CL8];
#pragma unroll
          for (int j = 0; j < CL8; ++j)
            xs[j] = cluster.map_shared_rank(xm_s, j)[tid];
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < CL8; ++j) mx = fmaxf(mx, xs[j]);
          const float m_prev = m_s[tid];
          const float m_new = fmaxf(m_prev, mx);
          c_s[tid] = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
          m_s[tid] = m_new;
        }
        __syncthreads();
        // p = exp(s - m) per lane; p * vsc back into the scratch
        float pmx = 0.f;
        for (int ln = warp; ln < gh; ln += NWARPS8) {
          const float mn = m_s[ln];
          float sum = 0.f, pm = 0.f;
          for (int r = lane; r < rows; r += 32) {
            float* e = sbuf + (size_t)(r0 + r - sbase) * (gh + 1);
            const float p = expf(e[ln] - mn);
            sum += p;
            const float pv = p * e[gh];
            e[ln] = pv;
            pm = fmaxf(pm, pv);
          }
          sum = dl4j::warp_sum(sum);
          pmx = fmaxf(pmx, dl4j::warp_max(pm));
          if (lane == 0) ls_s[ln] = sum;
        }
        if (lane == 0) red_s[warp] = pmx;
        __syncthreads();
        if (tid == 0) {
          float m = red_s[0];
          for (int w = 1; w < NWARPS8; ++w) m = fmaxf(m, red_s[w]);
          *pm_s = m;
        }
        // -- exchange 2: the tile's p scale and l (partial sums in rank order)
        cluster.sync();
        float pms[CL8];
#pragma unroll
        for (int j = 0; j < CL8; ++j) pms[j] = *cluster.map_shared_rank(pm_s, j);
        float m = 0.f;
#pragma unroll
        for (int j = 0; j < CL8; ++j) m = fmaxf(m, pms[j]);
        psc = fmaxf(m, 1e-30f) / 127.f;
        if (tid < gh) {
          float lss[CL8];
#pragma unroll
          for (int j = 0; j < CL8; ++j)
            lss[j] = cluster.map_shared_rank(ls_s, j)[tid];
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < CL8; ++j) s += lss[j];
          // _rn intrinsics: rounded as the reference rounds (no contraction)
          l_s[tid] = __fadd_rn(__fmul_rn(c_s[tid], l_s[tid]), s);
        }
      }
      if (i == total) break;
      fetch(i + NST8 - 1);
      cp_wait<NST8 - 1>();
      __syncthreads();
      const unsigned char* st = ring + (size_t)(i % NST8) * L.stage;
      const int plane = i >= nsub, si = i - plane * nsub;
      const int ts = r0 + si * rs, nr = min(rs, r1 - ts);
      if (!plane) {
        // scores: a thread per (row, head) pair, int8 dot products on
        // __dp4a (exact); each lane starts at its own word so the lanes of
        // a warp read distinct banks
        const float* sc = reinterpret_cast<const float*>(st + (size_t)rs * hk);
        for (int pr = tid; pr < nr * hkv; pr += NTHREADS8) {
          const int r = pr / hkv, h = pr % hkv;
          const int* krow =
              reinterpret_cast<const int*>(st + (size_t)r * hk + h * kd);
          const int w0 = lane % kd4;
          const float ksc = sc[2 * r] * scale;
          float* e = sbuf + (size_t)(ts + r - sbase) * (gh + 1);
          for (int g = 0; g < G; ++g) {
            const int* qg = q8 + g * hk4 + h * kd4;
            int dot = 0;
            for (int w = w0, k = 0; k < kd4; ++k) {
              dot = __dp4a(krow[w], qg[w], dot);
              if (++w == kd4) w = 0;
            }
            e[g * hkv + h] = (float)dot * ksc * qsc_s[g];
          }
          if (h == 0) e[gh] = sc[2 * r + 1];  // vsc of the row
        }
      } else {
        // p8 of the stage's rows, then int32 P V sums: a thread owns 4
        // columns (one word of every V row)
        for (int idx = tid; idx < nr * gh; idx += NTHREADS8) {
          const int r = idx / gh, ln = idx % gh;
          p8s[idx] = quant8(sbuf[(size_t)(ts + r - sbase) * (gh + 1) + ln] / psc);
        }
        __syncthreads();
        for (int w = tid; w < hk4; w += NTHREADS8) {
          const int h = (4 * w) / kd;
          for (int g = 0; g < G; ++g) {
            int* ip = ipart + g * hk + 4 * w;
            int a0 = ip[0], a1 = ip[1], a2 = ip[2], a3 = ip[3];
            const int8_t* pc = p8s + g * hkv + h;
            for (int r = 0; r < nr; ++r) {
              const int vw =
                  *reinterpret_cast<const int*>(st + (size_t)r * hk + 4 * w);
              const int p = pc[r * gh];
              a0 += p * (int)(int8_t)vw;
              a1 += p * (int)(int8_t)(vw >> 8);
              a2 += p * (int)(int8_t)(vw >> 16);
              a3 += p * (int)(int8_t)(vw >> 24);
            }
            ip[0] = a0;
            ip[1] = a1;
            ip[2] = a2;
            ip[3] = a3;
          }
        }
      }
      __syncthreads();
    }
    cp_wait<0>();

    // -- exchange 3: the int32 partials (exact in any order); this block
    // updates its slice of acc
    cluster.sync();
    for (int i = e0 + tid; i < e1; i += NTHREADS8) {
      int is[CL8];
#pragma unroll
      for (int j = 0; j < CL8; ++j) is[j] = cluster.map_shared_rank(ipart, j)[i];
      int isum = 0;
#pragma unroll
      for (int j = 0; j < CL8; ++j) isum += is[j];
      const int ln = (i / hk) * hkv + (i % hk) / kd;
      float* a = acc + (i - e0);
      *a = __fadd_rn(__fmul_rn(*a, c_s[ln]), __fmul_rn((float)isum, psc));
    }
    cluster.sync();  // partials and maxima stay alive until all have read
  }

  for (int i = e0 + tid; i < e1; i += NTHREADS8) {
    const int ln = (i / hk) * hkv + (i % hk) / kd;
    const float l = fmaxf(l_s[ln], 1e-30f);
    out[(size_t)b * G * hk + i] = from_f<TQ>(acc[i - e0] / l);
  }
}

template <typename TQ, bool PAGED>
cudaError_t launch_int8(const void* q, const void* cache, const float* scales,
                        const int* pos, float* scr, void* out,
                        const RowMap& map, int B, int G, int hkv, int kd,
                        int layer, float scale, int block_t,
                        cudaStream_t stream) {
  const Int8Layout L =
      int8_layout(G, hkv, kd, block_t, map.t, PAGED ? map.bps : 0);
  const int gran = granule(cache, (size_t)hkv * kd, (size_t)hkv * kd);
  return launch_cluster(flash_decode_int8_cluster_kernel<TQ, PAGED>,
                        dim3(CL8, B), NTHREADS8, L.total, CL8, stream,
                        static_cast<const TQ*>(q),
                        static_cast<const int8_t*>(cache), scales, pos, scr,
                        static_cast<TQ*>(out), map, G, hkv, kd, layer, scale,
                        block_t, gran);
}

template <bool PAGED>
int dispatch(const void* q, const void* cache, const void* scales,
             const int* pos, void* scratch, void* out, const RowMap& map,
             int B, int G, int hkv, int kd, int layer, float scale,
             int block_t, int dtype, int int8, cudaStream_t s) {
  if (B <= 0 || G <= 0 || hkv <= 0 || kd <= 0 || kd > MAXKD || map.t <= 0)
    return (int)cudaErrorInvalidValue;
  if (int8) {
    if (kd % 4 || G * hkv > MAXGH || scales == nullptr || block_t <= 0 ||
        block_t % 8 || (scratch == nullptr && !smem_scores8(G, hkv, block_t,
                                                             map.t)))
      return (int)cudaErrorInvalidValue;
    const float* sc = static_cast<const float*>(scales);
    float* scr = static_cast<float*>(scratch);
    if (dtype == dl4j::kF32)
      return (int)launch_int8<float, PAGED>(q, cache, sc, pos, scr, out, map,
                                            B, G, hkv, kd, layer, scale,
                                            block_t, s);
    if (dtype == dl4j::kBF16)
      return (int)launch_int8<__nv_bfloat16, PAGED>(
          q, cache, sc, pos, scr, out, map, B, G, hkv, kd, layer, scale,
          block_t, s);
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

// The grid (dims[0..2]) and cluster (dims[3..5]) of the calling thread's
// last successful launch of either entry point (zeros before the first).
extern "C" void dl4j_flash_decode_last_launch(int* dims) {
  for (int i = 0; i < 6; ++i) dims[i] = last_launch[i];
}

// Whether int8 mode needs the (B, t, G*hkv + 1) f32 score scratch for
// tiles of block_t rows of a t-row cache (else the scores stay in shared
// memory and `scratch` may be null).
extern "C" int dl4j_flash_decode_int8_scratch(int g, int hkv, int block_t,
                                              int t) {
  return !smem_scores8(g, hkv, block_t, t);
}

// Slab kernel #3. q, out: (B, G, hkv*kd) in `dtype`; cache: (n_layers, 2, B,
// t, hkv*kd) contiguous, in `dtype`, or int8 with `int8` set, `scales`
// (n_layers, 2, B, t, 1) f32 and `scratch` (B, t, G*hkv + 1) f32 where
// dl4j_flash_decode_int8_scratch says so (else null); block_t:
// the int8 tile (a positive multiple of 8; unused in bf16/f32 mode); pos:
// (B,) int32 on the device. Returns the launch's error.
extern "C" int dl4j_flash_decode(const void* q, const void* cache,
                                 const void* scales, const void* pos,
                                 void* scratch, void* out, int B, int G,
                                 int hkv, int kd, int t, int layer,
                                 int block_t, float scale, int dtype,
                                 int int8, void* stream) {
  RowMap map{nullptr, 0, 0, -1, t, (long long)B * t};
  return dispatch<false>(q, cache, scales, static_cast<const int*>(pos),
                         scratch, out, map, B, G, hkv, kd, layer, scale,
                         block_t, dtype, int8,
                         static_cast<cudaStream_t>(stream));
}

// Paged kernel #4. blocks: (n_layers, 2, n_blocks, bs, hkv*kd) (scales:
// (n_layers, 2, n_blocks, bs, 1) f32 in int8 mode); tables: (B, bps) int32
// block ids on the device; scratch (B, bps*bs, G*hkv + 1) f32 in int8 mode;
// everything else as dl4j_flash_decode.
extern "C" int dl4j_flash_decode_paged(const void* q, const void* blocks,
                                       const void* scales, const void* tables,
                                       const void* pos, void* scratch,
                                       void* out, int B, int G, int hkv,
                                       int kd, int n_blocks, int bs, int bps,
                                       int layer, int block_t, float scale,
                                       int dtype, int int8, void* stream) {
  if (bs <= 0 || bps <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  const int shift = (bs & (bs - 1)) ? -1 : __builtin_ctz((unsigned)bs);
  RowMap map{static_cast<const int*>(tables), bps, bs, shift, bps * bs,
             (long long)n_blocks * bs};
  return dispatch<true>(q, blocks, scales, static_cast<const int*>(pos),
                        scratch, out, map, B, G, hkv, kd, layer, scale,
                        block_t, dtype, int8,
                        static_cast<cudaStream_t>(stream));
}
