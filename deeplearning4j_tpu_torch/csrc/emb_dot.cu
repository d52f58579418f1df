// Fused embedding dot (kernel #5) for Hopper: the read side of Word2Vec's
// hierarchical-softmax step.
//
// Replaces: deeplearning4j_tpu/ops/pallas_kernels.py `_emb_dot_kernel`
// (:906, launched by `fused_embedding_dot` :918). The port's HS batch update
// (models/word2vec.py `_hs_math_merged`) calls it once per batch, for
// Word2Vec.fit and for ParagraphVectors' label pass.
//
// Inputs, all f32 and contiguous: h (B, D), the input rows; w (B, L, D), the
// syn1 rows of each target's Huffman path; mask (B, L). Outputs (B, L) f32:
//   f[b, l]        = sigmoid(clip(<h[b], w[b, l]>, -6, 6)) * mask[b, l]
//   in_range[b, l] = |<h[b], w[b, l]>| < 6 ? 1 : 0
// f is the reference kernel's function. in_range is the flag the HS step
// needs besides it: the step SKIPS pairs whose raw dot is saturated (the
// reference's exp-table range check), and the flag cannot be recovered from
// f in f32, so the kernel writes it in the same pass.
//
// Bound on the H100: bytes. A call must read w, h and mask and write f and
// in_range, 4 * (B*L*D + B*D + 3*B*L) bytes, at 2 FLOPs per element of w
// (about 0.5 FLOP a byte, far below the card's ridge). What the design does:
// one warp per (b, l) row; lanes stride over D in float4 (16-byte loads,
// neighbouring lanes on neighbouring addresses) when D % 4 == 0 and both
// rows are 16-byte aligned, else in floats; products summed in f32 (fmaf)
// and reduced with a shuffle; lane 0 clips, applies the sigmoid and the mask
// and writes both outputs. The L rows of one b read the same h row, which
// stays in L1/L2. f32 throughout: |dot| < 6 is a hard edge of the step.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;  // rows per 256-thread block
constexpr float kMaxExp = 6.f;

template <bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
    emb_dot_kernel(const float* __restrict__ h, const float* __restrict__ w,
                   const float* __restrict__ mask, float* __restrict__ f,
                   float* __restrict__ in_range, long long rows, int L,
                   int D) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp leaves together
  const float* hr = h + (row / L) * D;
  const float* wr = w + row * D;
  float acc = 0.f;
  if (VEC) {
    const float4* h4 = reinterpret_cast<const float4*>(hr);
    const float4* w4 = reinterpret_cast<const float4*>(wr);
    for (int i = lane; i < D / 4; i += 32) {
      const float4 a = h4[i];
      const float4 c = w4[i];
      acc = fmaf(a.x, c.x, acc);
      acc = fmaf(a.y, c.y, acc);
      acc = fmaf(a.z, c.z, acc);
      acc = fmaf(a.w, c.w, acc);
    }
  } else {
    for (int i = lane; i < D; i += 32) acc = fmaf(hr[i], wr[i], acc);
  }
  acc = dl4j::warp_sum(acc);
  if (lane == 0) {
    const float x = fminf(fmaxf(acc, -kMaxExp), kMaxExp);
    f[row] = 1.f / (1.f + expf(-x)) * mask[row];
    in_range[row] = fabsf(acc) < kMaxExp ? 1.f : 0.f;
  }
}

}  // namespace

// h (B, D), w (B, L, D), mask (B, L) f32 on the device; f, in_range (B, L)
// f32 outputs. `vec` selects float4 loads (the wrapper sets it when D % 4 ==
// 0 and h, w are 16-byte aligned). Returns cudaGetLastError().
extern "C" int dl4j_emb_dot(const void* h, const void* w, const void* mask,
                            void* f, void* in_range, int B, int L, int D,
                            int vec, void* stream) {
  if (B <= 0 || L <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * L;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const dim3 block(kWarps * 32);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* hp = static_cast<const float*>(h);
  const auto* wp = static_cast<const float*>(w);
  const auto* mp = static_cast<const float*>(mask);
  auto* fp = static_cast<float*>(f);
  auto* rp = static_cast<float*>(in_range);
  if (vec)
    emb_dot_kernel<true><<<grid, block, 0, s>>>(hp, wp, mp, fp, rp, rows, L, D);
  else
    emb_dot_kernel<false><<<grid, block, 0, s>>>(hp, wp, mp, fp, rp, rows, L,
                                                 D);
  return (int)cudaGetLastError();
}
