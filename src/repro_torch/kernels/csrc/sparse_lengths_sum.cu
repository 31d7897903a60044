// Ragged SparseLengthsSum over an (indices, offsets) stream:
//   out[b, :] = sum_{p = offsets[b] .. offsets[b] + len_b - 1}
//               table[indices[p], :]                             (f32)
// with len_b = min(offsets[b+1] - offsets[b], max_l), clamped at 0.
//
// Replaces the Pallas kernel repro/kernels/embedding_gather.py:125
// sparse_lengths_sum (body _ragged_kernel, :103). That kernel runs
// max_l grid steps per bag and masks the steps past the bag's end, so a
// bag longer than max_l sums its first max_l rows; this kernel does the
// same. Positions at or past offsets[n_bags] (the padded tail) are never
// read, and neither is any position past the stream's n entries.
//
// Bound: bytes. Each step reads one table row (D * 4 bytes, 128 B at
// D = 32) at a data-dependent address and adds it; the ids are read once
// and the offsets twice, 8 bytes a bag.
//
// Design: the TPU walks (bags, 1, max_l) grid steps in order, with both
// scalar arrays prefetched to SMEM, and carries the sum in VMEM. Here
// one warp owns a bag and reads offsets[b], offsets[b+1] and its ids
// straight from the stream, with no relayout into a dense matrix: 32 ids
// at a time, one per lane, broadcast with __shfl_sync, lanes strided
// over D so each step is one coalesced row read, the sum in a register
// in order of position. The walk stops at the bag's own length, so an
// empty bag writes zeros and no step is spent on masked positions; the
// sum equals fused_segment_sum's over the relayouted ids bit for bit
// (the fill slots there add +0.0 after the last row).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void sparse_lengths_sum_kernel(const float* __restrict__ table,
                                          const int32_t* __restrict__ ids,
                                          const int32_t* __restrict__ offsets,
                                          float* __restrict__ out, int n,
                                          int n_bags, int max_l, int dim) {
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // warp-uniform: the whole warp leaves
  const int start = offsets[bag];
  // never past the stream's valid end, nor past its n entries
  const int end = min(min(offsets[bag + 1], offsets[n_bags]), n);
  const int len = max(0, min(end - start, max_l));
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
    for (int j0 = 0; j0 < len; j0 += 32) {
      const int my_id = (j0 + lane < len) ? ids[start + j0 + lane] : 0;
      const int cnt = min(32, len - j0);
#pragma unroll 4
      for (int jj = 0; jj < cnt; ++jj) {
        const int64_t row = __shfl_sync(0xffffffffu, my_id, jj);
        if (d < dim) acc += table[row * dim + d];
      }
    }
    if (d < dim) out[static_cast<int64_t>(bag) * dim + d] = acc;
  }
}

}  // namespace

extern "C" int sparse_lengths_sum_f32(const float* table, const int32_t* ids,
                                      const int32_t* offsets, float* out,
                                      int n, int n_bags, int max_l, int dim,
                                      cudaStream_t stream) {
  const int blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sparse_lengths_sum_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      table, ids, offsets, out, n, n_bags, max_l, dim);
  return static_cast<int>(cudaGetLastError());
}
