// Segmented gather-reduce over a dense (n_bags, max_l) id matrix:
//   out[b, :] = sum_{j = 0 .. max_l-1} table[ids[b, j], :]     (f32)
//
// Replaces the Pallas kernel repro/kernels/fused_dispatch.py:61
// fused_segment_sum (body _fused_kernel, :43). Fill slots of short bags
// point at the arena's always-zero null row, so the walk needs no mask.
//
// Bound: bytes, and at the serving path's sizes the issue of the row
// reads. Each position reads one table row (D * 4 bytes, 128 B at D = 32)
// at a data-dependent address and adds it: one add per 4 bytes read.
//
// The bits: a bag's rows are added strictly in order of j, from 0.f.
// fused_cached_segment_sum, embedding_bag, sparse_lengths_sum and the
// int4 kernel over unpacked rows must equal this reduction bit for bit,
// which fixes the order; so there are no tree sums and no split bags.
//
// Design: a warp a bag, lane d on column d (32 columns a pass). A bag
// goes through in chunks of kDepth rows, the tile depth the wrapper's
// segment_plan picks from max_l (a multiple of 8 up to 64, the bag split
// into equal chunks). A chunk's ids are loaded two a lane and handed to
// the lanes by __shfl_sync, then all kDepth row reads are issued into
// registers, each one coalesced 128-byte load, before the first add; then
// lane d adds column d of the chunk's rows in order, the sum carried in a
// register across chunks. Rows past the bag's end read row 0 and are not
// added: the reads are left unpredicated, because ptxas holds the adds
// back behind predicated ones and keeps only a few in flight. At the
// serving sizes the reads' issue sets the pace (a matrix of null-row ids,
// all L1 hits, takes nearly as long; PERF.md, section 6), so the depth
// follows max_l rather than a fixed 64. The launch bounds fit the
// registers of 4 full blocks an SM for tiles of up to 48 rows, and of 3
// for deeper ones, whose values would spill under 4.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // the largest block the plan asks for

template <int kDepth>
__global__ void __launch_bounds__(kThreads, kDepth > 48 ? 3 : 4)
fused_segment_sum_kernel(const float* __restrict__ table,
                         const int32_t* __restrict__ ids,
                         float* __restrict__ out, int n_bags, int max_l,
                         int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // warp-uniform: the whole warp leaves
  const int32_t* bag_ids = ids + bag * max_l;
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    const bool col = d < dim;
    float acc = 0.f;
    for (int j0 = 0; j0 < max_l; j0 += kDepth) {
      const int n = min(kDepth, max_l - j0);
      int id[(kDepth + 31) / 32];
#pragma unroll
      for (int k = 0; k < (kDepth + 31) / 32; ++k) {
        id[k] = 32 * k + lane < n ? __ldg(bag_ids + j0 + 32 * k + lane) : 0;
      }
      float v[kDepth];
#pragma unroll
      for (int r = 0; r < kDepth; ++r) {  // every lane shuffles and loads
        const int64_t row = __shfl_sync(0xffffffffu, id[r / 32], r & 31);
        v[r] = __ldg(table + row * dim + (col ? d : 0));
      }
#pragma unroll
      for (int r = 0; r < kDepth; ++r) {
        if (r < n) acc = __fadd_rn(acc, v[r]);
      }
    }
    if (col) out[bag * dim + d] = acc;
  }
}

template <int kDepth>
int launch(const float* table, const int32_t* ids, float* out, int n_bags,
           int max_l, int dim, int blocks, int warps_per_block,
           cudaStream_t stream) {
  fused_segment_sum_kernel<kDepth><<<blocks, 32 * warps_per_block, 0,
                                     stream>>>(table, ids, out, n_bags, max_l,
                                               dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks, warps_per_block and depth come from the wrapper's segment_plan;
// the grid has a warp for every bag
extern "C" int fused_segment_sum_f32(const float* table, const int32_t* ids,
                                     float* out, int n_bags, int max_l,
                                     int dim, int blocks, int warps_per_block,
                                     int depth, cudaStream_t stream) {
  if (blocks < 1 || warps_per_block < 1 ||
      32 * warps_per_block > kThreads ||
      static_cast<int64_t>(blocks) * warps_per_block < n_bags) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define FSS_DEPTH(k)                                                        \
  case k:                                                                   \
    return launch<k>(table, ids, out, n_bags, max_l, dim, blocks,           \
                     warps_per_block, stream);
  switch (depth) {
    FSS_DEPTH(8) FSS_DEPTH(16) FSS_DEPTH(24) FSS_DEPTH(32)
    FSS_DEPTH(40) FSS_DEPTH(48) FSS_DEPTH(56) FSS_DEPTH(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FSS_DEPTH
}
