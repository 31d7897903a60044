// One-pass hot/cold segmented reduce over a dense (n_bags, max_l) id
// matrix of a hot-row cache:
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
// Two entries, one walk. (a) fused_cached_segment_sum_f32 takes the TPU
// kernel's two matrices (slots, cold ids). (b) fused_cached_segment_stage_f32
// takes the dense ids and the cache's slot map (slot_of, one int32 per
// arena row) and makes the split itself: a lane loads its ids, then
// slot_of[id] for each, a gathered 4-byte load in flight with the
// chunk's other loads, so the caller's three launches (the slot gather,
// the test, the where) and the two (B, max_l) matrices they write go.
//
// Bound: bytes, and at the serving path's sizes the issue of the row
// reads. Each position reads one row (D * 4 bytes, 128 B at D = 32) at a
// data-dependent address and adds it, one add per 4 bytes read.
//
// Design: fused_segment_sum.cu's walk with the hit test inside. A warp a
// bag, lane d on column d; a bag in chunks of kDepth rows, the depth the
// wrapper's segment_plan picks from max_l. A chunk's ids (and slots) are
// loaded two a lane, and the lane that holds a position makes its hit
// test, slot < K, and the row's address, hot + slot * D or arena + cold *
// D. The address goes to the other lanes by __shfl_sync, as two 32-bit
// halves, so a row costs two shuffles, a 64-bit add of the lane's column
// and the read: the test and the choice of table are made once a
// position, not once a lane and position (handing out the slot and the
// cold id and choosing in every lane took more than twice
// fused_segment_sum's time; PERF.md, section 6). A position costs one row
// read, not the reference's two, and all kDepth reads of the chunk are
// issued into registers before the first __fadd_rn. Rows past the bag's
// end read arena row 0 (the stage form: id 0, slot_of[0] and its row)
// and are not added: the reads are left unpredicated, as in
// fused_segment_sum.cu, so that ptxas keeps them all in flight. A bag's
// terms are added strictly in order of j from 0.f, so on a coherent
// cache every term, and so every sum, equals fused_segment_sum's bit for
// bit. The TPU keeps the hot rows in VMEM; here the hot arena (4,097 x
// 32 x 4 B = 512 KB at K = 4,096) and the slot map (4 MB for DLRM(1))
// are left to the 50 MB L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // the largest block the plan asks for

// blocks an SM at the launch bound, so that a thread's registers (the
// chunk's kDepth values, its rows' addresses, the pointers) fit without a
// spill: 64 registers up to 16 rows, 73 up to 40, 85 up to 56, 102 beyond
constexpr int min_blocks(int depth) {
  return depth <= 16 ? 8 : depth <= 40 ? 7 : depth <= 56 ? 6 : 5;
}

// kStage: `first` holds the dense ids and `second` the slot map;
// otherwise `first` holds the slots and `second` the cold ids
template <int kDepth, bool kStage>
__global__ void __launch_bounds__(kThreads, min_blocks(kDepth))
fused_cached_segment_sum_kernel(const float* __restrict__ hot,
                                const float* __restrict__ arena,
                                const int32_t* __restrict__ first,
                                const int32_t* __restrict__ second,
                                float* __restrict__ out, int n_bags,
                                int max_l, int dim, int k) {
  constexpr int kIds = (kDepth + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // warp-uniform: the whole warp leaves
  const int32_t* bag_first = first + bag * max_l;
  const int32_t* bag_second = kStage ? second : second + bag * max_l;
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    const bool col = d < dim;
    float acc = 0.f;
    for (int j0 = 0; j0 < max_l; j0 += kDepth) {
      const int n = min(kDepth, max_l - j0);
      uint64_t src[kIds];  // the address of each position's one row
#pragma unroll
      for (int q = 0; q < kIds; ++q) {
        const int j = 32 * q + lane;
        int slot, row;
        if (kStage) {
          row = j < n ? __ldg(bag_first + j0 + j) : 0;
          slot = __ldg(second + row);
        } else {
          slot = j < n ? __ldg(bag_first + j0 + j) : k;
          row = j < n ? __ldg(bag_second + j0 + j) : 0;
        }
        src[q] = reinterpret_cast<uint64_t>(
            slot < k ? hot + static_cast<int64_t>(slot) * dim
                     : arena + static_cast<int64_t>(row) * dim);
      }
      float v[kDepth];
#pragma unroll
      for (int r = 0; r < kDepth; ++r) {  // every lane shuffles and loads
        const uint32_t lo = __shfl_sync(
            0xffffffffu, static_cast<uint32_t>(src[r / 32]), r & 31);
        const uint32_t hi = __shfl_sync(
            0xffffffffu, static_cast<uint32_t>(src[r / 32] >> 32), r & 31);
        const float* row = reinterpret_cast<const float*>(
            (static_cast<uint64_t>(hi) << 32) | lo);
        v[r] = __ldg(row + (col ? d : 0));
      }
#pragma unroll
      for (int r = 0; r < kDepth; ++r) {
        if (r < n) acc = __fadd_rn(acc, v[r]);
      }
    }
    if (col) out[bag * dim + d] = acc;
  }
}

template <int kDepth, bool kStage>
int launch(const float* hot, const float* arena, const int32_t* first,
           const int32_t* second, float* out, int n_bags, int max_l, int dim,
           int k, int blocks, int warps_per_block, cudaStream_t stream) {
  fused_cached_segment_sum_kernel<kDepth, kStage>
      <<<blocks, 32 * warps_per_block, 0, stream>>>(
          hot, arena, first, second, out, n_bags, max_l, dim, k);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStage>
int dispatch(const float* hot, const float* arena, const int32_t* first,
             const int32_t* second, float* out, int n_bags, int max_l,
             int dim, int k, int blocks, int warps_per_block, int depth,
             cudaStream_t stream) {
  if (blocks < 1 || warps_per_block < 1 ||
      32 * warps_per_block > kThreads ||
      static_cast<int64_t>(blocks) * warps_per_block < n_bags) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define FCSS_DEPTH(n)                                                      \
  case n:                                                                  \
    return launch<n, kStage>(hot, arena, first, second, out, n_bags,       \
                             max_l, dim, k, blocks, warps_per_block,       \
                             stream);
  switch (depth) {
    FCSS_DEPTH(8) FCSS_DEPTH(16) FCSS_DEPTH(24) FCSS_DEPTH(32)
    FCSS_DEPTH(40) FCSS_DEPTH(48) FCSS_DEPTH(56) FCSS_DEPTH(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FCSS_DEPTH
}

}  // namespace

// (a) the TPU kernel's form. blocks, warps_per_block and depth come from
// the wrapper's segment_plan; the grid has a warp for every bag
extern "C" int fused_cached_segment_sum_f32(
    const float* hot, const float* arena, const int32_t* slots,
    const int32_t* cold, float* out, int n_bags, int max_l, int dim, int k,
    int blocks, int warps_per_block, int depth, cudaStream_t stream) {
  return dispatch<false>(hot, arena, slots, cold, out, n_bags, max_l, dim, k,
                         blocks, warps_per_block, depth, stream);
}

// (b) the stage form: the split from the dense ids and the slot map
extern "C" int fused_cached_segment_stage_f32(
    const float* hot, const int32_t* slot_of, const float* arena,
    const int32_t* dense, float* out, int n_bags, int max_l, int dim, int k,
    int blocks, int warps_per_block, int depth, cudaStream_t stream) {
  return dispatch<true>(hot, arena, dense, slot_of, out, n_bags, max_l, dim,
                        k, blocks, warps_per_block, depth, stream);
}
