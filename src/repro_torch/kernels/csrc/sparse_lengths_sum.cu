// Ragged SparseLengthsSum over an (indices, offsets) stream:
//   out[b, :] = sum_{p = offsets[b] .. offsets[b] + len_b - 1}
//               table[indices[p], :]                             (f32)
// with len_b = min(offsets[b+1], offsets[n_bags], n) - offsets[b],
// clamped to [0, max_l].
//
// Replaces the Pallas kernel repro/kernels/embedding_gather.py:125
// sparse_lengths_sum (body _ragged_kernel, :103). That kernel runs
// max_l grid steps per bag and masks the steps past the bag's end, so a
// bag longer than max_l sums its first max_l rows; this kernel does the
// same. Positions at or past offsets[n_bags] (the padded tail, whose ids
// may be out of range) are never loaded as ids, and neither is any
// position past the stream's n entries.
//
// Bound: bytes, and at the serving path's sizes the issue of the row
// reads. Each position reads one table row (D * 4 bytes, 128 B at D = 32)
// at a data-dependent address and adds it; the ids are read once and the
// offsets twice, 8 bytes a bag.
//
// The bits: a bag's rows are added strictly in order of position, from
// 0.f, with __fadd_rn; no tree sums, no split bags. So a bag equals
// fused_segment_sum's over the relayouted ids bit for bit (the fill
// slots there add +0.0 after the last row).
//
// Design: fused_segment_sum.cu's walk over the stream, with no relayout
// into a dense matrix. A warp a bag, lane d on column d (passes of 32
// columns). Lanes 0, 1 and 2 load offsets[b], offsets[b + 1] and
// offsets[n_bags] in one instruction and shuffle them to the others. The
// bag goes through in chunks of kDepth positions, the depth the wrapper's
// sls_plan picks from min(max_l, 40): max_l may be a loose bound (the host
// tier passes the stream's length), and there a chunk of 40 beat one of
// 64 (PERF.md, section 6), so no deeper chunk is built. The chunk loop
// stops at the bag's own length, so an empty bag issues no read and
// writes zeros. A chunk's
// ids are loaded one or two a lane, only at positions inside the bag,
// and handed out by __shfl_sync; every row read of the chunk is issued
// into registers, unpredicated, before the first add. Reads past the
// bag's end read row 0 and are never added (the wrapper refuses an empty
// table); they stay unpredicated because ptxas holds the adds back
// behind predicated ones and keeps only a few in flight (PERF.md,
// section 6).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // the largest block the plan asks for

// blocks an SM at the launch bound: a chunk's kDepth values, its ids, the
// bag's bounds and the pointers fit in 64 registers up to 40 rows
constexpr int kMinBlocks = 8;

template <int kDepth>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
sparse_lengths_sum_kernel(const float* __restrict__ table,
                          const int32_t* __restrict__ ids,
                          const int32_t* __restrict__ offsets,
                          float* __restrict__ out, int n, int n_bags,
                          int max_l, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // warp-uniform: the whole warp leaves
  const int o = lane < 3 ? __ldg(offsets + (lane == 0   ? bag
                                            : lane == 1 ? bag + 1
                                                        : n_bags))
                         : 0;
  const int start = __shfl_sync(0xffffffffu, o, 0);
  // never past the stream's valid end, nor past its n entries
  const int end = min(min(__shfl_sync(0xffffffffu, o, 1),
                          __shfl_sync(0xffffffffu, o, 2)), n);
  const int len = max(0, min(end - start, max_l));
  const int32_t* bag_ids = ids + start;
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    const bool col = d < dim;
    float acc = 0.f;
    for (int j0 = 0; j0 < len; j0 += kDepth) {
      const int cnt = min(kDepth, len - j0);
      int id[(kDepth + 31) / 32];
#pragma unroll
      for (int k = 0; k < (kDepth + 31) / 32; ++k) {
        id[k] = 32 * k + lane < cnt ? __ldg(bag_ids + j0 + 32 * k + lane)
                                    : 0;
      }
      float v[kDepth];
#pragma unroll
      for (int r = 0; r < kDepth; ++r) {  // every lane shuffles and loads
        const int64_t row = __shfl_sync(0xffffffffu, id[r / 32], r & 31);
        v[r] = __ldg(table + row * dim + (col ? d : 0));
      }
#pragma unroll
      for (int r = 0; r < kDepth; ++r) {
        if (r < cnt) acc = __fadd_rn(acc, v[r]);
      }
    }
    if (col) out[bag * dim + d] = acc;
  }
}

template <int kDepth>
int launch(const float* table, const int32_t* ids, const int32_t* offsets,
           float* out, int n, int n_bags, int max_l, int dim, int blocks,
           int warps_per_block, cudaStream_t stream) {
  sparse_lengths_sum_kernel<kDepth>
      <<<blocks, 32 * warps_per_block, 0, stream>>>(
          table, ids, offsets, out, n, n_bags, max_l, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks, warps_per_block and depth come from the wrapper's sls_plan; the
// grid has a warp for every bag
extern "C" int sparse_lengths_sum_f32(const float* table, const int32_t* ids,
                                      const int32_t* offsets, float* out,
                                      int n, int n_bags, int max_l, int dim,
                                      int blocks, int warps_per_block,
                                      int depth, cudaStream_t stream) {
  if (blocks < 1 || warps_per_block < 1 ||
      32 * warps_per_block > kThreads ||
      static_cast<int64_t>(blocks) * warps_per_block < n_bags) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define SLS_DEPTH(k)                                                        \
  case k:                                                                   \
    return launch<k>(table, ids, offsets, out, n, n_bags, max_l, dim,       \
                     blocks, warps_per_block, stream);
  switch (depth) {
    SLS_DEPTH(8) SLS_DEPTH(16) SLS_DEPTH(24) SLS_DEPTH(32) SLS_DEPTH(40)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SLS_DEPTH
}
