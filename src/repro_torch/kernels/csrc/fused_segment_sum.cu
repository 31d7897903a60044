// Segmented gather-reduce over a dense (n_bags, max_l) id matrix:
//   out[b, :] = sum_{j = 0 .. max_l-1} table[ids[b, j], :]     (f32)
//
// Replaces the Pallas kernel repro/kernels/fused_dispatch.py:61
// fused_segment_sum (body _fused_kernel, :43). Fill slots of short bags
// point at the arena's always-zero null row, so the walk needs no mask.
//
// Bound: bytes. Each step reads one table row (D * 4 bytes, 128 B at
// D = 32) at a data-dependent address and adds it; there is one add per
// byte-quad read, far below the card's operations-per-byte balance.
//
// Design: one warp per bag, lanes strided over D, so each step is one
// coalesced row read. The warp loads 32 of its bag's ids at a time (one
// per lane) and broadcasts them with __shfl_sync. The f32 accumulator
// stays in a register and the sum runs strictly in order of j: the later
// hot/cold kernel (fused_cached_segment_sum) must equal this reduction
// bit for bit, which fixes the order here.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void fused_segment_sum_kernel(const float* __restrict__ table,
                                         const int32_t* __restrict__ ids,
                                         float* __restrict__ out,
                                         int n_bags, int max_l, int dim) {
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // warp-uniform: the whole warp leaves
  const int32_t* bag_ids = ids + static_cast<int64_t>(bag) * max_l;
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
    for (int j0 = 0; j0 < max_l; j0 += 32) {
      const int my_id = (j0 + lane < max_l) ? bag_ids[j0 + lane] : 0;
      const int n = min(32, max_l - j0);
#pragma unroll 4
      for (int jj = 0; jj < n; ++jj) {
        const int64_t row = __shfl_sync(0xffffffffu, my_id, jj);
        if (d < dim) acc += table[row * dim + d];
      }
    }
    if (d < dim) out[static_cast<int64_t>(bag) * dim + d] = acc;
  }
}

}  // namespace

extern "C" int fused_segment_sum_f32(const float* table, const int32_t* ids,
                                     float* out, int n_bags, int max_l,
                                     int dim, cudaStream_t stream) {
  const int blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_segment_sum_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      table, ids, out, n_bags, max_l, dim);
  return static_cast<int>(cudaGetLastError());
}
