// Int4 dequantize-in-the-gather segmented reduce over a dense
// (n_bags, max_l) id matrix:
//   out[b, c] = sum_{j = 0 .. max_l-1} code(packed[ids[b, j]], c)
//                                      * scales[ids[b, j]]        (f32)
// with code(row, c) the biased nibble of column c less 8: the low nibble
// of byte c / 2 for even c, the high one for odd c.
//
// Replaces the Pallas kernel repro/kernels/fused_dispatch.py:183
// fused_int4_segment_sum (body _int4_kernel, :159), the cold tier of
// tiered storage (repro/storage/tiered.py Int4Arena). Fill slots point
// at a row of zero codes (bias 8) and zero scale, so the walk needs no
// mask.
//
// Bound: bytes. Each step reads one packed row (ceil(D/2) bytes, 16 B at
// D = 32) and its 4-byte scale at data-dependent addresses, an eighth of
// the fp32 row, but in two 32-byte sectors, since row and scale sit
// apart; two operations per value, far below the card's balance.
//
// Design: one warp per bag, lanes strided over D, as fused_segment_sum
// does. Lane c reads byte c >> 1 of the row (lanes 2k and 2k+1 share a
// byte, so the warp's row read is one 16-byte span), and every lane reads
// the row's scale (one broadcast load). The warp loads 32 of its bag's
// ids at a time and broadcasts them with __shfl_sync.
//
// Arithmetic order is the point of the design. Each term is the rounded
// product float(code) * scale, then a rounded add, summed in order of j
// from 0.f: __fmul_rn and __fadd_rn keep nvcc from contracting the two
// into one FMA. So the kernel equals fused_segment_sum over
// int4_unpack(packed, scales) (whose values are those rounded products)
// bit for bit, and its plain version up to the order of the sum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void fused_int4_segment_sum_kernel(
    const uint8_t* __restrict__ packed, const float* __restrict__ scales,
    const int32_t* __restrict__ ids, float* __restrict__ out, int n_bags,
    int max_l, int dim, int width) {
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // warp-uniform: the whole warp leaves
  const int32_t* bag_ids = ids + static_cast<int64_t>(bag) * max_l;
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    const int shift = (d & 1) * 4;
    float acc = 0.f;
    for (int j0 = 0; j0 < max_l; j0 += 32) {
      const int my_id = (j0 + lane < max_l) ? bag_ids[j0 + lane] : 0;
      const int n = min(32, max_l - j0);
#pragma unroll 4
      for (int jj = 0; jj < n; ++jj) {
        const int64_t row = __shfl_sync(0xffffffffu, my_id, jj);
        const float scale = scales[row];
        if (d < dim) {
          const int code =
              static_cast<int>((packed[row * width + (d >> 1)] >> shift) &
                               0xF) - 8;
          acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(code), scale));
        }
      }
    }
    if (d < dim) out[static_cast<int64_t>(bag) * dim + d] = acc;
  }
}

}  // namespace

extern "C" int fused_int4_segment_sum_f32(const uint8_t* packed,
                                          const float* scales,
                                          const int32_t* ids, float* out,
                                          int n_bags, int max_l, int dim,
                                          int width, cudaStream_t stream) {
  const int blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_int4_segment_sum_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      packed, scales, ids, out, n_bags, max_l, dim, width);
  return static_cast<int>(cudaGetLastError());
}
