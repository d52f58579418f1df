// Fused embedding dot (kernel #5) for Hopper, in two modes over one body:
// the reference's function on dense rows, and the read side of Word2Vec's
// hierarchical-softmax step fused with the gathers and products around it.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py `_emb_dot_kernel`
// (:906, launched by `fused_embedding_dot` :918).
//
// Dense mode (`dl4j_emb_dot`), the reference's contract: h (B, D), w
// (B, L, D), mask (B, L), all f32; outputs (B, L) f32
//   f[b, l]        = sigmoid(clip(<h[b], w[b, l]>, -6, 6)) * mask[b, l]
//   in_range[b, l] = |<h[b], w[b, l]>| < 6 ? 1 : 0
// in_range is the flag the HS step needs besides f: the step SKIPS pairs
// whose raw dot is saturated (the reference's exp-table range check), and
// the flag cannot be recovered from f in f32.
//
// Fused mode (`dl4j_emb_dot_hs`), what models/word2vec.py `_hs_math_merged`
// computes before its scatter, for the merged table S (rows, D) f32, inputs
// (B,) and points (B, L) int64, codes and mask (B, L) f32, lr f32:
//   h = S[inputs[b]], w_l = S[v + points[b, l]], f and in_range as above,
//   g_l = (1 - codes - f) * lr * mask * in_range   (this order)
//   grad_in[b] = sum_l g_l * w_l                   (ascending l)
//   delta[b, l] = g_l * h
// written to one (B + B*L, D) buffer: entry i of the scatter's index list
// cat([inputs, (v + points).reshape(-1)]) (grad_in[b] is entry b, delta[b, l]
// entry B + b*L + l) at row dest[i], dest being a permutation (the sorted
// scatter's inverse permutation). f and g never leave the kernel. Entries
// with mask 0, which the scatter skips, are not written: the scatter plan
// puts them past every kept entry, where its sums read nothing. An index out
// of range (an input or a valid path row outside S, a dest outside the
// buffer) traps, a sticky launch failure as PyTorch's device-side index
// assert is, instead of reading or writing past the tables.
//
// What bounds it on the H100: bytes; about 1 FLOP a byte, far below the
// card's ridge. Fused, a batch must read each distinct row it touches once
// (the syn1 rows of the paths, 28.5 MB for all of syn1 at V 71,290, D 100,
// fit the 50 MB L2 and the root is on every path), the index arrays, and
// write the kept delta rows (B + the valid path entries, x D x 4 bytes).
// What the design does about it:
// - one warp per batch row b, looping over the row's path; h[b] is loaded
//   once, by index, and held in registers, lanes striding over D in float4
//   (16-byte loads and stores, neighbouring lanes on neighbouring
//   addresses) when D % 4 == 0 and the tables are 16-byte aligned, else in
//   floats; C chunks a lane (C = ceil(D / 4 / 32), at most 4; a wider row
//   takes the C = 0 body, which streams h and w from L1/L2 and keeps
//   grad_in in its output row);
// - the warp loads a window of 32 path entries at once (mask, then the
//   points, codes and dest of the valid ones, mask > 0: one coalesced load
//   a lane) and takes the valid ones from a ballot, so neither the row nor
//   the indices of a padded entry (mask 0) are loaded;
// - rows in flight: the loads of U = max(1, FLIGHT / C) path rows are
//   issued together, then their U dots are shuffle-reduced together;
// - grad_in stays in registers, accumulated in ascending l with fmaf, and
//   every output row is written by one warp: deterministic, no atomics;
// - every delta row is written once, with float4 stores from all lanes, at
//   its scatter position, so the step materializes no gathered w, no
//   g (x) h product and no permuted copy of it.
// Dense mode runs the same body with the dense row map (row (b, l) of w)
// and every entry active (f and the flag of a masked entry still need the
// dot); it writes f and the flag with one coalesced store a window.
// f32 throughout: |dot| < 6 is a hard edge of the step.
// Measured alternatives (scripts/torch_emb_dot_sweep.py builds this source
// with other WARPS and FLIGHT; device ms by CUDA-graph replay on an NVIDIA
// H100 80GB HBM3 at 700 W, B 4096, D 100: fused on a Word2Vec batch of
// 47,157 valid path entries / fused at L 16 / dense at L 22):
//   WARPS 4, FLIGHT 4 (kept)  0.01054 / 0.01031 / 0.01326
//   FLIGHT 1                  0.01301 / 0.01306 / 0.01793
//   FLIGHT 2                  0.01122 / 0.01097 / 0.01638
//   FLIGHT 8 (84 registers)   0.01280 / 0.01287 / 0.01361
//   WARPS 2                   0.01092 / 0.01024 / 0.01282
//   WARPS 8                   0.01159 / 0.00991 / 0.01273
// (the Word2Vec batch is the main path's, so its column decides).
// The previous design, one warp per (b, l) row over a gathered w, ran the
// dense mode alone at 0.0276 ms a batch of the same fit, beside 0.36 ms of
// gathers and 0.18 ms of elementwise work that the fused mode removes in
// part (scripts/torch_w2v_compare.py).
#include "common.cuh"

namespace {

constexpr int WARPS = 4;   // batch rows per block, one warp each
constexpr int FLIGHT = 4;  // row chunks a lane keeps in flight
constexpr float kMaxExp = 6.f;
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const float* h;           // dense: (B, D)
  const float* w;           // dense: (B, L, D); fused: the table S
  const float* mask;        // (B, L)
  const float* codes;       // fused: (B, L)
  const long long* inputs;  // fused: (B,)
  const long long* points;  // fused: (B, L)
  const long long* dest;    // fused: (B + B*L,)
  float* f;                 // dense: (B, L)
  float* in_range;          // dense: (B, L)
  float* out;               // fused: (B + B*L, D)
  long long v;              // fused: row of syn1's first row in S
  long long rows;           // fused: rows of S
  float lr;
  int B, L, D;
};

// a row chunk: float4 (VEC) or float
template <bool VEC>
struct Chunk;
template <>
struct Chunk<true> {
  using T = float4;
  static __device__ __forceinline__ T zero() { return make_float4(0, 0, 0, 0); }
  static __device__ __forceinline__ float dot(T a, T b, float acc) {
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    return fmaf(a.w, b.w, acc);
  }
  static __device__ __forceinline__ T axpy(float g, T w, T acc) {
    return make_float4(fmaf(g, w.x, acc.x), fmaf(g, w.y, acc.y),
                       fmaf(g, w.z, acc.z), fmaf(g, w.w, acc.w));
  }
  static __device__ __forceinline__ T scale(float g, T h) {
    return make_float4(g * h.x, g * h.y, g * h.z, g * h.w);
  }
};
template <>
struct Chunk<false> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ float dot(T a, T b, float acc) {
    return fmaf(a, b, acc);
  }
  static __device__ __forceinline__ T axpy(float g, T w, T acc) {
    return fmaf(g, w, acc);
  }
  static __device__ __forceinline__ T scale(float g, T h) { return g * h; }
};

// FUSED selects the row map and the epilogue; C is the number of chunks a
// lane holds in registers (0: stream any width from L1/L2).
template <bool FUSED, bool VEC, int C>
__global__ void __launch_bounds__(WARPS * 32)
    emb_dot_kernel(const Params p) {
  using K = Chunk<VEC>;
  using T = typename K::T;
  constexpr int U = C == 0 ? 1 : (FLIGHT / C > 1 ? FLIGHT / C : 1);
  constexpr int CR = C > 0 ? C : 1;  // register array length
  const int b = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (b >= p.B) return;  // the whole warp leaves together
  const int n = VEC ? p.D / 4 : p.D;  // chunks a row
  const long long D = p.D;

  const long long n_out = p.B + (long long)p.B * p.L;  // fused: entries
  const T* hrow;
  T* grow = nullptr;  // fused: grad_in's output row
  if constexpr (FUSED) {
    const long long in_b = p.inputs[b], d_b = p.dest[b];
    if (in_b < 0 || in_b >= p.rows || d_b < 0 || d_b >= n_out) __trap();
    hrow = reinterpret_cast<const T*>(p.w + in_b * D);
    grow = reinterpret_cast<T*>(p.out + d_b * D);
  } else {
    hrow = reinterpret_cast<const T*>(p.h + (long long)b * D);
  }
  T hr[CR], gr[CR];
#pragma unroll
  for (int c = 0; c < CR; ++c) {
    const int j = c * 32 + lane;
    hr[c] = (C > 0 && j < n) ? hrow[j] : K::zero();
    gr[c] = K::zero();
  }
  if constexpr (FUSED && C == 0)
    for (int j = lane; j < n; j += 32) grow[j] = K::zero();

  for (int l0 = 0; l0 < p.L; l0 += 32) {
    const int l = l0 + lane;
    const bool in = l < p.L;
    const long long e = (long long)b * p.L + l;  // entry (b, l)
    const float m = in ? p.mask[e] : 0.f;
    float code = 0.f;
    long long row = 0, dst = 0;
    if constexpr (FUSED) {
      if (in && m > 0.f) {
        code = p.codes[e];
        row = p.v + p.points[e];
        dst = p.dest[p.B + e];
        if (row < 0 || row >= p.rows || dst < 0 || dst >= n_out) __trap();
      }
    }
    unsigned left = __ballot_sync(kAll, FUSED ? (in && m > 0.f) : in);
    float f_out = 0.f, r_out = 0.f;  // dense: lane l's outputs
    while (left) {
      int lk[U];  // the group's path entries, -1 past the last
#pragma unroll
      for (int k = 0; k < U; ++k) {
        lk[k] = left ? __ffs(left) - 1 : -1;
        left &= left - 1;
      }
      const T* wr[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int src = lk[k] < 0 ? 0 : lk[k];
        const long long r =
            FUSED ? __shfl_sync(kAll, row, src) : e - lane + src;
        wr[k] = reinterpret_cast<const T*>(p.w + r * D);
      }
      float dot[U];
      T wv[C > 0 ? U : 1][CR];
      if constexpr (C > 0) {
#pragma unroll
        for (int k = 0; k < U; ++k)
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const int j = c * 32 + lane;
            wv[k][c] = (lk[k] >= 0 && j < n) ? wr[k][j] : K::zero();
          }
#pragma unroll
        for (int k = 0; k < U; ++k) {
          dot[k] = 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) dot[k] = K::dot(hr[c], wv[k][c], dot[k]);
        }
      } else {
        dot[0] = 0.f;
        if (lk[0] >= 0)
          for (int j = lane; j < n; j += 32)
            dot[0] = K::dot(hrow[j], wr[0][j], dot[0]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int k = 0; k < U; ++k)
          dot[k] += __shfl_xor_sync(kAll, dot[k], o);
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int src = lk[k] < 0 ? 0 : lk[k];
        const float mk = __shfl_sync(kAll, m, src);
        const float ck = __shfl_sync(kAll, code, src);
        const long long dk = __shfl_sync(kAll, dst, src);
        if (lk[k] < 0) break;  // uniform across the warp
        const float x = fminf(fmaxf(dot[k], -kMaxExp), kMaxExp);
        const float fk = 1.f / (1.f + expf(-x)) * mk;
        const float rk = fabsf(dot[k]) < kMaxExp ? 1.f : 0.f;
        if constexpr (!FUSED) {
          if (lane == lk[k]) {
            f_out = fk;
            r_out = rk;
          }
        } else {
          const float g = (1.f - ck - fk) * p.lr * mk * rk;
          T* drow = reinterpret_cast<T*>(p.out + dk * D);
          if constexpr (C > 0) {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const int j = c * 32 + lane;
              gr[c] = K::axpy(g, wv[k][c], gr[c]);
              if (j < n) drow[j] = K::scale(g, hr[c]);
            }
          } else {
            for (int j = lane; j < n; j += 32) {
              grow[j] = K::axpy(g, wr[k][j], grow[j]);
              drow[j] = K::scale(g, hrow[j]);
            }
          }
        }
      }
    }
    if constexpr (!FUSED) {
      if (in) {
        p.f[e] = f_out;
        p.in_range[e] = r_out;
      }
    }
  }
  if constexpr (FUSED && C > 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = c * 32 + lane;
      if (j < n) grow[j] = gr[c];
    }
  }
}

template <bool FUSED, bool VEC>
cudaError_t launch(const Params& p, cudaStream_t s) {
  const dim3 grid((unsigned)((p.B + WARPS - 1) / WARPS));
  const dim3 block(WARPS * 32);
  const int n = VEC ? p.D / 4 : p.D;
  switch ((n + 31) / 32) {
    case 1:
      emb_dot_kernel<FUSED, VEC, 1><<<grid, block, 0, s>>>(p);
      break;
    case 2:
      emb_dot_kernel<FUSED, VEC, 2><<<grid, block, 0, s>>>(p);
      break;
    case 3:
      emb_dot_kernel<FUSED, VEC, 3><<<grid, block, 0, s>>>(p);
      break;
    case 4:
      emb_dot_kernel<FUSED, VEC, 4><<<grid, block, 0, s>>>(p);
      break;
    default:
      emb_dot_kernel<FUSED, VEC, 0><<<grid, block, 0, s>>>(p);
  }
  return cudaGetLastError();
}

template <bool FUSED>
int launch_any(const Params& p, int vec, void* stream) {
  if (p.B <= 0 || p.L < 0 || p.D <= 0) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return (int)(vec ? launch<FUSED, true>(p, s) : launch<FUSED, false>(p, s));
}

}  // namespace

// Dense mode. h (B, D), w (B, L, D), mask (B, L) f32 on the device; f,
// in_range (B, L) f32 outputs. `vec` selects float4 chunks (the wrapper sets
// it when D % 4 == 0 and h, w are 16-byte aligned). Returns
// cudaGetLastError().
extern "C" int dl4j_emb_dot(const void* h, const void* w, const void* mask,
                            void* f, void* in_range, int B, int L, int D,
                            int vec, void* stream) {
  if (L <= 0) return (int)cudaErrorInvalidValue;
  Params p{};
  p.h = static_cast<const float*>(h);
  p.w = static_cast<const float*>(w);
  p.mask = static_cast<const float*>(mask);
  p.f = static_cast<float*>(f);
  p.in_range = static_cast<float*>(in_range);
  p.B = B;
  p.L = L;
  p.D = D;
  return launch_any<false>(p, vec, stream);
}

// Fused mode. S (rows, D) f32; inputs (B,) and points (B, L) int64 (syn1
// rows at v + points); codes, mask (B, L) f32; dest (B + B*L,) int64; out
// (B + B*L, D) f32. `vec` selects float4 chunks (the wrapper sets it when
// D % 4 == 0 and S, out are 16-byte aligned). Returns cudaGetLastError().
extern "C" int dl4j_emb_dot_hs(const void* S, long long rows, long long v,
                               const void* inputs, const void* codes,
                               const void* points, const void* mask,
                               const void* dest, float lr, void* out, int B,
                               int L, int D, int vec, void* stream) {
  if (!dest) return (int)cudaErrorInvalidValue;
  Params p{};
  p.rows = rows;
  p.w = static_cast<const float*>(S);
  p.inputs = static_cast<const long long*>(inputs);
  p.codes = static_cast<const float*>(codes);
  p.points = static_cast<const long long*>(points);
  p.mask = static_cast<const float*>(mask);
  p.dest = static_cast<const long long*>(dest);
  p.out = static_cast<float*>(out);
  p.v = v;
  p.lr = lr;
  p.B = B;
  p.L = L;
  p.D = D;
  return launch_any<true>(p, vec, stream);
}
