// Output-stationary fp32 matrix product: out(M, N) = x(M, K) @ w(K, N).
//
// Replaces the Pallas kernel repro/kernels/gemm.py:39 gemm (body
// _gemm_kernel, :21), the dense engine of every MLP layer.
//
// Bound: on the serving path M is the bucket (1..32) and N, K are at most
// 512, so the product is small and the time goes to reading w once
// (K * N * 4 bytes): bytes, not operations. At M = 2048 it turns towards
// the 67 TFLOP/s fp32 (non-tensor-core) rate.
//
// Design: true fp32, FMA on the CUDA cores; no TF32 and no mma, since the
// reference accumulates in full f32. A block owns a 32 x 32 output tile
// in registers (output-stationary, as on the TPU) and streams 32-deep
// slices of x and w through shared memory. Each of its 256 threads holds
// four outputs of one column. All edges are masked in the kernel (zero
// fill), so the path's ragged shapes -- K = 13 and 47, N = 1, M = 1..32
// -- need no padding and no divisor of K, unlike the Pallas version,
// which snapped its K-block to a divisor of K.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;          // BM = BN = BK
constexpr int kThreads = 256;      // 8 row groups x 32 columns
constexpr int kRowsPerThread = kTile / (kThreads / kTile);  // 4

__global__ void gemm_f32_kernel(const float* __restrict__ x,
                                const float* __restrict__ w,
                                float* __restrict__ out,
                                int m, int n, int k) {
  __shared__ float xs[kTile][kTile + 1];
  __shared__ float ws[kTile][kTile];
  const int tx = threadIdx.x % kTile;   // output column in the tile
  const int ty = threadIdx.x / kTile;   // rows ty, ty + 8, ty + 16, ty + 24
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  float acc[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < k; k0 += kTile) {
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty + i * (kThreads / kTile);
      const int xr = row0 + r, xc = k0 + tx;
      xs[r][tx] = (xr < m && xc < k)
                      ? x[static_cast<int64_t>(xr) * k + xc] : 0.f;
      const int wr = k0 + r, wc = col0 + tx;
      ws[r][tx] = (wr < k && wc < n)
                      ? w[static_cast<int64_t>(wr) * n + wc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTile; ++kk) {
      const float b = ws[kk][tx];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        acc[i] = fmaf(xs[ty + i * (kThreads / kTile)][kk], b, acc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = row0 + ty + i * (kThreads / kTile);
    const int c = col0 + tx;
    if (r < m && c < n) out[static_cast<int64_t>(r) * n + c] = acc[i];
  }
}

}  // namespace

extern "C" int gemm_f32(const float* x, const float* w, float* out, int m,
                        int n, int k, cudaStream_t stream) {
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  gemm_f32_kernel<<<grid, kThreads, 0, stream>>>(x, w, out, m, n, k);
  return static_cast<int>(cudaGetLastError());
}
