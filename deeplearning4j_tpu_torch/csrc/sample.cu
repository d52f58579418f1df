// The categorical draw on the reference's threefry key stream, for Hopper:
// jax.random.categorical with threefry2x32 keys and partitionable counters,
// fused with its key fold, bits, uniforms, Gumbel noise and row argmax.
//
// Replaces no TPU kernel: the reference computes this in XLA
// (`jax.random.categorical`, deeplearning4j_tpu/serving/engine.py:293, :418,
// :519; models/transformer.py:1511, :1951). It is a kernel the port adds,
// held to the port's rules: a plain version beside it
// (ops/threefry.py `categorical_plain`) and checks on the card.
//
// Computes, for f32 logits (R, V) (already filtered and scaled) and keys:
//   per-row mode (pos given): key_r = threefry2x32(keys[r], (0, pos[r])),
//     counter of element v = v;
//   flat mode (pos null): key_r = keys (one key), counter = r * V + v;
//   bits  = y0 ^ y1 of threefry2x32(key_r, (counter >> 32, counter & M32))
//   u     = max(tiny, ((bits >> 9 | 0x3F800000) as f32 - 1) + tiny)
//   p     = -log(-log(u)) + logits[r, v]
//   tok[r] = the first v of the maximum of p, val[r] = that maximum
//     (a -0.0 maximum as +0.0).
// logf, not __logf, and no fast-math flags: the kernel rounds as PyTorch's
// log does on the card, so it and the plain version agree bitwise.
//
// What bounds it on the H100: operations. About 86 a logit (72 for the
// twenty threefry rounds and six key injections, the rest the counter,
// the uniform, two logs, the add and the compare) against 4 bytes read:
// at R 8, V 50,304 the 1.6 MB of logits take 0.48 us at 3.35 TB/s, the
// 35 M operations longer. What the design does about it:
// - rows x 1,024-logit chunks as the grid (400 blocks at R 8, V 50,304),
//   so every SM issues; each thread draws 4 logits, neighbouring threads
//   on neighbouring logits (coalesced loads);
// - a rotate is one funnel shift (`__funnelshift_l`);
// - the argmax is a max over 64-bit ordered keys (the value's bits made
//   monotone, then the complement of the index, so ties go to the lower
//   index): warp shuffles, then one partial a block into a (R, C) scratch
//   tensor the wrapper allocates, then a second small pass that reduces a
//   row's partials in one warp. Deterministic: no atomics, no order of
//   arrival.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kChunk = kThreads * kPerThread;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN, the uniforms' floor

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds (Random123's, as jax.random's threefry2x32).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define DL4J_TF_ROUND(r) \
  x0 += x1;              \
  x1 = rotl(x1, r) ^ x0;
#define DL4J_TF_GROUP0 \
  DL4J_TF_ROUND(13) DL4J_TF_ROUND(15) DL4J_TF_ROUND(26) DL4J_TF_ROUND(6)
#define DL4J_TF_GROUP1 \
  DL4J_TF_ROUND(17) DL4J_TF_ROUND(29) DL4J_TF_ROUND(16) DL4J_TF_ROUND(24)
  x0 += k0;
  x1 += k1;
  DL4J_TF_GROUP0
  x0 += k1;
  x1 += k2 + 1u;
  DL4J_TF_GROUP1
  x0 += k2;
  x1 += k0 + 2u;
  DL4J_TF_GROUP0
  x0 += k0;
  x1 += k1 + 3u;
  DL4J_TF_GROUP1
  x0 += k1;
  x1 += k2 + 4u;
  DL4J_TF_GROUP0
  x0 += k2;
  x1 += k0 + 5u;
#undef DL4J_TF_GROUP1
#undef DL4J_TF_GROUP0
#undef DL4J_TF_ROUND
}

// (value, index) as one key whose unsigned order is (value ascending, index
// descending); -0.0 is first made +0.0 so the two compare equal, as they do
// in argmax.
__device__ __forceinline__ unsigned long long pack(float v, int idx) {
  uint32_t u = __float_as_uint(v + 0.0f);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         (0xFFFFFFFFu - static_cast<uint32_t>(idx));
}

__device__ __forceinline__ unsigned long long warp_max_u64(
    unsigned long long x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
    threefry_draw_partial_kernel(const float* __restrict__ logits,
                                 const long long* __restrict__ keys,
                                 const int* __restrict__ pos,
                                 unsigned long long* __restrict__ part, int V,
                                 int C) {
  const int r = blockIdx.y;
  const int c = blockIdx.x;
  uint32_t k0, k1;
  unsigned long long base;
  if (pos != nullptr) {
    uint32_t y0 = 0u, y1 = static_cast<uint32_t>(pos[r]);
    threefry2x32(static_cast<uint32_t>(keys[2 * r]),
                 static_cast<uint32_t>(keys[2 * r + 1]), y0, y1);
    k0 = y0;
    k1 = y1;
    base = 0ull;
  } else {
    k0 = static_cast<uint32_t>(keys[0]);
    k1 = static_cast<uint32_t>(keys[1]);
    base = static_cast<unsigned long long>(r) * static_cast<unsigned>(V);
  }
  const float* row = logits + static_cast<size_t>(r) * V;
  unsigned long long best = 0ull;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int v = c * kChunk + j * kThreads + threadIdx.x;
    if (v < V) {
      const unsigned long long ctr = base + static_cast<unsigned>(v);
      uint32_t x0 = static_cast<uint32_t>(ctr >> 32);
      uint32_t x1 = static_cast<uint32_t>(ctr);
      threefry2x32(k0, k1, x0, x1);
      const uint32_t bits = x0 ^ x1;
      const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
      const float u = fmaxf(kTiny, f + kTiny);
      const float p = -logf(-logf(u)) + row[v];
      const unsigned long long key = pack(p, v);
      best = key > best ? key : best;
    }
  }
  best = warp_max_u64(best);
  __shared__ unsigned long long warp_best[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? warp_best[lane] : 0ull;
    best = warp_max_u64(best);
    if (lane == 0) part[static_cast<size_t>(r) * C + c] = best;
  }
}

// One warp a row: the maximum of its C partials, unpacked.
__global__ void __launch_bounds__(128)
    threefry_draw_reduce_kernel(const unsigned long long* __restrict__ part,
                                int R, int C, int* __restrict__ tok,
                                float* __restrict__ val) {
  const int r = blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  unsigned long long best = 0ull;
  for (int c = lane; c < C; c += 32) {
    const unsigned long long x = part[static_cast<size_t>(r) * C + c];
    best = x > best ? x : best;
  }
  best = warp_max_u64(best);
  if (lane == 0) {
    const uint32_t u = static_cast<uint32_t>(best >> 32);
    const uint32_t bits = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
    tok[r] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(best));
    val[r] = __uint_as_float(bits);
  }
}

}  // namespace

// logits (R, V) f32; keys (R, 2) int64 words with pos (R,) int32, or keys
// (2,) with pos null; part (R, ceil(V / 1024)) int64 scratch; tok (R,)
// int32, val (R,) f32. Returns cudaGetLastError() after both launches.
extern "C" int dl4j_threefry_draw(const void* logits, const void* keys,
                                  const void* pos, void* part, void* tok,
                                  void* val, int R, int V, void* stream) {
  if (R <= 0 || V <= 0 || R > 65535) return (int)cudaErrorInvalidValue;
  const int C = (V + kChunk - 1) / kChunk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  threefry_draw_partial_kernel<<<dim3(C, R), kThreads, 0, s>>>(
      static_cast<const float*>(logits), static_cast<const long long*>(keys),
      static_cast<const int*>(pos), static_cast<unsigned long long*>(part), V,
      C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  threefry_draw_reduce_kernel<<<(R + 3) / 4, 128, 0, s>>>(
      static_cast<const unsigned long long*>(part), R, C,
      static_cast<int*>(tok), static_cast<float*>(val));
  return (int)cudaGetLastError();
}
