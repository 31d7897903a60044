// Centaur's feature-interaction unit (paper Fig. 3 / Fig. 11), one launch
// each way.
//
// Replaces the Pallas kernel repro/kernels/feature_interaction.py:30
// interaction (body _interact_kernel, :20), Z = X X^T per sample, and
// the ops around it in repro/core/dense_engine.py:42-51 (the concat of
// the features, the strictly-lower triangle of Z, the concat with the
// bottom MLP's output) and their VJP (repro/kernels/ops.py:422-429).
// On a TPU, XLA fuses those ops into their neighbours; on the card each
// would be a launch and a host dispatch of its own, so they live here.
//
// Three C entries, one body:
//   interaction_stage_f32: bottom (B, D) and embs (B, T, D), read in
//     place, give out (B, D + P) = [bottom, tril(X X^T, -1)] in the
//     row-major order of jnp.tril_indices(F, k=-1), and feats (B, F, D) =
//     X = [bottom; embs], with F = T + 1 and P = F (F - 1) / 2. Only the
//     P pairs the stage keeps are computed.
//   interaction_stage_backward_f32: from G (B, D + P), an optional
//     gradient of feats and the saved bottom and embs, d_bottom (B, D) and
//     d_embs (B, T, D): dX = Gsym X, Gsym holding pair p's gradient at
//     (i, j) and (j, i) and zeros on the diagonal (the reference's
//     (G + G^T) X over the kept triangle), plus the feats gradient, plus
//     G[:, :D] into d_bottom.
//   interaction_f32: the TPU kernel's own function, x (B, F, D) -> Z
//     (B, F, F), every dot.
//
// Bound: bytes. At DLRM(1)'s F = 6, D = 32 a sample reads 768 bytes and
// writes 956 for 15 dots of 32 products: under one flop a byte.
//
// Design: a group of threads per sample (a warp per 128 work items, 1 to
// 8 warps) and up to 256 threads a block. While the samples do not fill
// two blocks an SM, a block holds one sample, so at B = 32 the samples
// run on 32 SMs at once; past that a block holds several. The group
// copies its sample's rows into shared memory with coalesced reads (and,
// in the forward, writes feats and the bottom copy from the same
// registers), then each thread takes work items in a stride: a pair's
// dot, or an element of dX. Rows are padded to D + 1 floats in the
// forward, so threads reading different rows at one d hit different
// banks; in the backward the threads of a warp read one row at
// consecutive d.
//
// The bits: a dot is summed in order of d with fmaf from 0.f, and an
// element of dX in order of the other feature g, then the feats gradient
// and the pass-through are added, in that order. Which thread computes an
// item never changes its arithmetic, so a sample's outputs do not depend
// on B or on the grid, and two launches give the same bits. No atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kItemsPerWarp = 128;
constexpr size_t kStaticShared = 48 * 1024;
constexpr size_t kMaxShared = 227 * 1024;

// threads of one sample's group: a warp per kItemsPerWarp work items
int sample_threads(int items) {
  const int warps = (items + kItemsPerWarp - 1) / kItemsPerWarp;
  return 32 * (warps < 1 ? 1 : (warps > kMaxThreads / 32 ? kMaxThreads / 32
                                                          : warps));
}

// samples a block holds: one until there are two blocks on each of the
// card's sms, then as many as the block's threads and shared memory take
int samples_per_block(int b, int tps, size_t sample_bytes, int sms) {
  const int fill = b / (2 * (sms < 1 ? 1 : sms));
  int most = kMaxThreads / tps;
  const size_t fit = sample_bytes ? kMaxShared / sample_bytes : most;
  if (fit < static_cast<size_t>(most)) most = static_cast<int>(fit);
  return fill < 1 ? 1 : (fill > most ? most : fill);
}

// pair p of the strictly-lower triangle, in row-major order: the row i is
// guessed from the inverse of p = i (i - 1) / 2 + j and corrected, so the
// result does not rest on the rounding of sqrtf
__device__ __forceinline__ void pair_of(int p, int& i, int& j) {
  int r = static_cast<int>((1.f + sqrtf(8.f * p + 1.f)) * 0.5f);
  while (r * (r - 1) / 2 > p) --r;
  while ((r + 1) * r / 2 <= p) ++r;
  i = r;
  j = p - r * (r - 1) / 2;
}

__device__ __forceinline__ float dot(const float* a, const float* b, int d) {
  float acc = 0.f;
  for (int k = 0; k < d; ++k) acc = fmaf(a[k], b[k], acc);
  return acc;
}

// kStage: rows from bottom (row 0) and x (rows 1..f-1), out the stage's
//   (B, D + P) and feats (B, F, D);
// else: rows from x (B, F, D), out (B, F, F)
template <bool kStage>
__global__ void __launch_bounds__(kMaxThreads)
interaction_forward_kernel(const float* __restrict__ bottom,
                           const float* __restrict__ x,
                           float* __restrict__ out, float* __restrict__ feats,
                           int b, int f, int d, int tps, int spb) {
  extern __shared__ float xs[];
  const int ld = d + 1;
  const int slot = threadIdx.x / tps;
  const int t = threadIdx.x - slot * tps;
  const int s = blockIdx.x * spb + slot;
  const bool live = s < b;  // a block syncs: no early return
  float* xsm = xs + static_cast<size_t>(slot) * f * ld;
  const int p_n = kStage ? f * (f - 1) / 2 : f * f;
  const int width = kStage ? d + p_n : p_n;
  float* ob = out + static_cast<int64_t>(s) * width;
  if (live) {
    const int x_rows = kStage ? f - 1 : f;
    const float* xb = x + static_cast<int64_t>(s) * x_rows * d;
    if (kStage) {
      const float* bb = bottom + static_cast<int64_t>(s) * d;
      float* fb = feats + static_cast<int64_t>(s) * f * d;
      for (int k = t; k < d; k += tps) {
        const float v = bb[k];
        xsm[k] = v;
        ob[k] = v;
        fb[k] = v;
      }
      for (int k = t; k < x_rows * d; k += tps) {
        const int r = k / d;
        const float v = xb[k];
        xsm[(r + 1) * ld + (k - r * d)] = v;
        fb[d + k] = v;
      }
    } else {
      for (int k = t; k < x_rows * d; k += tps) {
        const int r = k / d;
        xsm[r * ld + (k - r * d)] = xb[k];
      }
    }
  }
  __syncthreads();
  if (!live) return;
  if (kStage) {
    for (int p = t; p < p_n; p += tps) {
      int i, j;
      pair_of(p, i, j);
      ob[d + p] = dot(xsm + i * ld, xsm + j * ld, d);
    }
  } else {
    for (int e = t; e < p_n; e += tps) {
      const int i = e / f;
      ob[e] = dot(xsm + i * ld, xsm + (e - i * f) * ld, d);
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
interaction_backward_kernel(const float* __restrict__ g,
                            const float* __restrict__ g_feats,
                            const float* __restrict__ bottom,
                            const float* __restrict__ embs,
                            float* __restrict__ d_bottom,
                            float* __restrict__ d_embs, int b, int f, int d,
                            int tps, int spb) {
  extern __shared__ float sm[];
  const int p_n = f * (f - 1) / 2;
  const int slot = threadIdx.x / tps;
  const int t = threadIdx.x - slot * tps;
  const int s = blockIdx.x * spb + slot;
  const bool live = s < b;
  float* xsm = sm + static_cast<size_t>(slot) * (f * d + p_n);  // X, f x d
  float* gp = xsm + f * d;                                       // P pairs
  const float* gs = g + static_cast<int64_t>(s) * (d + p_n);
  if (live) {
    const float* bb = bottom + static_cast<int64_t>(s) * d;
    const float* eb = embs + static_cast<int64_t>(s) * (f - 1) * d;
    for (int k = t; k < d; k += tps) xsm[k] = bb[k];
    for (int k = t; k < (f - 1) * d; k += tps) xsm[d + k] = eb[k];
    for (int k = t; k < p_n; k += tps) gp[k] = gs[d + k];
  }
  __syncthreads();
  if (!live) return;
  const float* gf = g_feats ? g_feats + static_cast<int64_t>(s) * f * d
                            : nullptr;
  for (int e = t; e < f * d; e += tps) {
    const int fi = e / d;
    const int k = e - fi * d;
    float acc = 0.f;
    for (int gi = 0; gi < f; ++gi) {
      if (gi == fi) continue;
      const int p = gi > fi ? gi * (gi - 1) / 2 + fi : fi * (fi - 1) / 2 + gi;
      acc = fmaf(gp[p], xsm[gi * d + k], acc);
    }
    if (gf) acc = __fadd_rn(acc, gf[e]);
    if (fi == 0) {
      d_bottom[static_cast<int64_t>(s) * d + k] = __fadd_rn(acc, gs[k]);
    } else {
      d_embs[static_cast<int64_t>(s) * (f - 1) * d + (e - d)] = acc;
    }
  }
}

// dynamic shared memory above the static 48 KB needs the kernel's opt-in
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes > kMaxShared) return cudaErrorInvalidValue;
  if (bytes <= kStaticShared) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <bool kStage>
int forward(const float* bottom, const float* x, float* out, float* feats,
            int b, int f, int d, int sms, cudaStream_t stream) {
  const int items = kStage ? f * (f - 1) / 2 : f * f;
  const int tps = sample_threads(items);
  const size_t sample_bytes = static_cast<size_t>(f) * (d + 1) * sizeof(float);
  const int spb = samples_per_block(b, tps, sample_bytes, sms);
  const size_t smem = spb * sample_bytes;
  cudaError_t err = allow_shared(interaction_forward_kernel<kStage>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interaction_forward_kernel<kStage><<<(b + spb - 1) / spb, spb * tps, smem,
                                       stream>>>(bottom, x, out, feats, b, f,
                                                 d, tps, spb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sms: the card's multiprocessors, which only spread the work
extern "C" int interaction_f32(const float* x, float* out, int b, int f,
                               int d, int sms, cudaStream_t stream) {
  return forward<false>(nullptr, x, out, nullptr, b, f, d, sms, stream);
}

extern "C" int interaction_stage_f32(const float* bottom, const float* embs,
                                     float* out, float* feats, int b, int t,
                                     int d, int sms, cudaStream_t stream) {
  return forward<true>(bottom, embs, out, feats, b, t + 1, d, sms, stream);
}

extern "C" int interaction_stage_backward_f32(
    const float* g, const float* g_feats, const float* bottom,
    const float* embs, float* d_bottom, float* d_embs, int b, int t, int d,
    int sms, cudaStream_t stream) {
  const int f = t + 1;
  const int tps = sample_threads(f * d);
  const size_t sample_bytes =
      static_cast<size_t>(f * d + f * (f - 1) / 2) * sizeof(float);
  const int spb = samples_per_block(b, tps, sample_bytes, sms);
  const size_t smem = spb * sample_bytes;
  cudaError_t err = allow_shared(interaction_backward_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  interaction_backward_kernel<<<(b + spb - 1) / spb, spb * tps, smem,
                                stream>>>(g, g_feats, bottom, embs, d_bottom,
                                          d_embs, b, f, d, tps, spb);
  return static_cast<int>(cudaGetLastError());
}
