// Batched pairwise-dot feature interaction: out[b] = X_b X_b^T,
// x (B, F, D) -> out (B, F, F), fp32 accumulation.
//
// Replaces the Pallas kernel repro/kernels/feature_interaction.py:30
// interaction (body _interact_kernel, :20). The lower-triangle
// extraction stays outside, in kernels/ops.py, as in the reference.
//
// Bound: bytes. DLRM(1) has F = 6 and D = 32: 2 * F * F * D = 2304 flops
// per 768 bytes of input, about 3 flops a byte, far below the card's
// balance.
//
// Design: one block per group of kSamplesPerBlock samples. The block
// copies its samples' contiguous F x D slabs into shared memory with
// coalesced reads, rows padded to D + 1 floats so that threads reading
// different rows at the same d hit different banks. Each thread then
// writes whole F x F dots, summed in order of d with fmaf, and the
// output is written contiguously.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSamplesPerBlock = 8;
constexpr int kThreads = 256;
constexpr size_t kMaxShared = 48 * 1024;  // static limit, no opt-in

__global__ void interaction_kernel(const float* __restrict__ x,
                                   float* __restrict__ out, int b, int f,
                                   int d, int spb) {
  extern __shared__ float xs[];
  const int b0 = blockIdx.x * spb;
  const int nb = min(spb, b - b0);
  const int ld = d + 1;
  const float* xb = x + static_cast<int64_t>(b0) * f * d;
  for (int i = threadIdx.x; i < nb * f * d; i += blockDim.x) {
    const int row = i / d;  // sample * f + feature
    xs[row * ld + (i - row * d)] = xb[i];
  }
  __syncthreads();
  float* ob = out + static_cast<int64_t>(b0) * f * f;
  const int ff = f * f;
  for (int i = threadIdx.x; i < nb * ff; i += blockDim.x) {
    const int s = i / ff;
    const int p = (i - s * ff) / f;
    const int q = i - s * ff - p * f;
    const float* xp = xs + (s * f + p) * ld;
    const float* xq = xs + (s * f + q) * ld;
    float acc = 0.f;
    for (int k = 0; k < d; ++k) acc = fmaf(xp[k], xq[k], acc);
    ob[i] = acc;
  }
}

}  // namespace

extern "C" int interaction_f32(const float* x, float* out, int b, int f,
                               int d, cudaStream_t stream) {
  const size_t sample_bytes = static_cast<size_t>(f) * (d + 1) * sizeof(float);
  if (sample_bytes > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
  int spb = kSamplesPerBlock;
  while (spb > 1 && spb * sample_bytes > kMaxShared) --spb;
  const int blocks = (b + spb - 1) / spb;
  interaction_kernel<<<blocks, kThreads, spb * sample_bytes, stream>>>(
      x, out, b, f, d, spb);
  return static_cast<int>(cudaGetLastError());
}
