// One-pass hot/cold segmented reduce over two dense (n_bags, max_l) id
// matrices of the same bags:
//   out[b, :] = sum_{j = 0 .. max_l-1} hot[slots[b, j], :]
//                                    + arena[cold[b, j], :]        (f32)
//
// Replaces the Pallas kernel repro/kernels/fused_dispatch.py:116
// fused_cached_segment_sum (body _cached_kernel, :95), the embedding stage
// of the hot-row cached serving path (CachedSource over an fp arena).
// hot is (K + 1, D) with slot K always zero; arena is (V, D) with the
// null row always zero. A hit (slot < K) has its cold id redirected to
// the null row, a miss has slot K, so per position exactly one of the two
// terms is nonzero.
//
// Bound: bytes. Each position reads one row (D * 4 bytes, 128 B at
// D = 32) at a data-dependent address and adds it, one add per 4 bytes
// read, far below the card's operations-per-byte balance.
//
// Design: the in-kernel hit test reads only the nonzero term: the warp
// tests slot < K and reads that one row, from the hot arena or the cold
// one, so a position costs one row read and not the reference's two. The
// value is the reference's two-term sum whenever the zero-slot and
// null-row invariants hold. The TPU keeps the hot rows in VMEM; here the
// hot arena (4,097 x 32 x 4 B = 512 KB at K = 4,096) is too big for a
// block's shared memory and is left to the 50 MB L2, where the Zipf-hot
// rows of a batch stay resident. As in fused_segment_sum.cu: one warp per
// bag, lanes strided over D (one coalesced row per step), 32 ids of each
// matrix loaded per step and broadcast with __shfl_sync (the test is
// warp-uniform, so no lane diverges), and the f32 accumulator runs
// strictly in order of j. On a coherent cache every term equals the
// uncached kernel's term bit for bit, so the two kernels' sums are equal
// bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void fused_cached_segment_sum_kernel(
    const float* __restrict__ hot, const float* __restrict__ arena,
    const int32_t* __restrict__ slots, const int32_t* __restrict__ cold,
    float* __restrict__ out, int n_bags, int max_l, int dim, int k) {
  const unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int bag = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // warp-uniform: the whole warp leaves
  const int64_t base = static_cast<int64_t>(bag) * max_l;
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
    for (int j0 = 0; j0 < max_l; j0 += 32) {
      const bool mine = j0 + lane < max_l;
      const int my_slot = mine ? slots[base + j0 + lane] : k;
      const int my_cold = mine ? cold[base + j0 + lane] : 0;
      const int n = min(32, max_l - j0);
#pragma unroll 4
      for (int jj = 0; jj < n; ++jj) {
        const int s = __shfl_sync(kAll, my_slot, jj);
        const int c = __shfl_sync(kAll, my_cold, jj);
        const float* row = s < k ? hot + static_cast<int64_t>(s) * dim
                                 : arena + static_cast<int64_t>(c) * dim;
        if (d < dim) acc += row[d];
      }
    }
    if (d < dim) out[static_cast<int64_t>(bag) * dim + d] = acc;
  }
}

}  // namespace

extern "C" int fused_cached_segment_sum_f32(const float* hot,
                                            const float* arena,
                                            const int32_t* slots,
                                            const int32_t* cold, float* out,
                                            int n_bags, int max_l, int dim,
                                            int k, cudaStream_t stream) {
  const int blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  fused_cached_segment_sum_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                                    stream>>>(hot, arena, slots, cold, out,
                                              n_bags, max_l, dim, k);
  return static_cast<int>(cudaGetLastError());
}
