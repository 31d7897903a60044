// Fixed-lookup SparseLengthsSum over a (n_bags, n_l) id matrix:
//   out[b, :] = sum_{l = 0 .. n_l-1} table[ids[b, l], :]        (f32)
//
// Replaces the Pallas kernel repro/kernels/embedding_gather.py:57
// embedding_bag (body _bag_kernel, :40) and, with n_l = 1, :93
// gather_rows. The fixed layout has no fill slots: every id is a real
// row, any row of the table, so nothing here assumes a zero null row.
//
// Bound: bytes, and at the serving path's sizes the issue of the row
// reads. Each step reads one table row (D * 4 bytes, 128 B at D = 32) at
// a data-dependent address and adds it; one add per 4 bytes read, far
// below the card's operations-per-byte balance.
//
// The bits: a bag's rows are added strictly in order of l, from 0.f, with
// __fadd_rn; no tree sums, no split bags. A bag of L rows then equals,
// bit for bit, fused_segment_sum over the same rows followed by fill
// slots of the zero null row (x + 0.0 == x), so the fixed plan serves the
// ragged fp plan's exact probabilities on equal-length bags.
//
// Design: fused_segment_sum.cu's walk. A warp a bag, lane d on column d
// (passes of 32 columns). A bag goes through in chunks of kDepth rows,
// the depth the wrapper's bag_plan picks from n_l (segment_plan's: a
// multiple of 8 up to 64, the bag split into equal chunks, 24 for
// DLRM(1)'s 20 rows, two chunks of 40 for DLRM(3)'s 80; and a depth of 1
// for gather_rows' single rows, which would otherwise issue 7 wasted
// reads a row, on blocks of up to 8 warps: a warp that reads one row is
// done at once, and fewer, larger blocks launch faster). A chunk's ids
// are loaded one or two a lane and handed to the lanes by __shfl_sync;
// then every read of the chunk is issued into registers, unpredicated,
// before the first add. The reads past the bag's
// end read row 0, which is a real row here, and are never added: the
// wrapper refuses an empty table, so row 0 exists. The reads stay
// unpredicated because ptxas holds the adds back behind predicated ones
// and keeps only a few in flight (PERF.md, section 6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the largest block the plan asks for: 4 warps, 8 for single-row bags
constexpr int kThreads = 256;

// blocks of kThreads an SM at the launch bound: a chunk's kDepth values,
// its ids and the pointers fit in 64 registers up to 48 rows and in 85
// beyond
constexpr int min_blocks(int depth) { return depth <= 48 ? 4 : 3; }

template <int kDepth>
__global__ void __launch_bounds__(kThreads, min_blocks(kDepth))
embedding_bag_kernel(const float* __restrict__ table,
                     const int32_t* __restrict__ ids,
                     float* __restrict__ out, int n_bags, int n_l, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // warp-uniform: the whole warp leaves
  const int32_t* bag_ids = ids + bag * n_l;
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    const bool col = d < dim;
    float acc = 0.f;
    for (int l0 = 0; l0 < n_l; l0 += kDepth) {
      const int n = min(kDepth, n_l - l0);
      int id[(kDepth + 31) / 32];
#pragma unroll
      for (int k = 0; k < (kDepth + 31) / 32; ++k) {
        id[k] = 32 * k + lane < n ? __ldg(bag_ids + l0 + 32 * k + lane) : 0;
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
           int n_l, int dim, int blocks, int warps_per_block,
           cudaStream_t stream) {
  embedding_bag_kernel<kDepth><<<blocks, 32 * warps_per_block, 0, stream>>>(
      table, ids, out, n_bags, n_l, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks, warps_per_block and depth come from the wrapper's bag_plan; the
// grid has a warp for every bag
extern "C" int embedding_bag_f32(const float* table, const int32_t* ids,
                                 float* out, int n_bags, int n_l, int dim,
                                 int blocks, int warps_per_block, int depth,
                                 cudaStream_t stream) {
  if (blocks < 1 || warps_per_block < 1 ||
      32 * warps_per_block > kThreads ||
      static_cast<int64_t>(blocks) * warps_per_block < n_bags) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define EB_DEPTH(k)                                                         \
  case k:                                                                   \
    return launch<k>(table, ids, out, n_bags, n_l, dim, blocks,             \
                     warps_per_block, stream);
  switch (depth) {
    EB_DEPTH(1) EB_DEPTH(8) EB_DEPTH(16) EB_DEPTH(24) EB_DEPTH(32)
    EB_DEPTH(40) EB_DEPTH(48) EB_DEPTH(56) EB_DEPTH(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef EB_DEPTH
}
