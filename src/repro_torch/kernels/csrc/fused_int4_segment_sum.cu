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
// Bound: bytes, and at the serving path's sizes the issue of the reads.
// Each position reads one packed row (ceil(D/2) bytes, 16 B at D = 32)
// and its 4-byte scale at data-dependent addresses, an eighth of the
// fp32 row, but in two 32-byte sectors, since row and scale sit apart;
// two operations per value, far below the card's balance.
//
// Design: fused_segment_sum.cu's walk. A warp a bag, lane d on column d
// (passes of 32 columns), reading byte d >> 1 of the packed row (lanes 2k
// and 2k + 1 share a byte, so the warp's read is one span of the row). A
// bag goes through in chunks of kDepth rows (the depth segment_plan picks
// from max_l). A chunk's ids are loaded by the lanes, and each lane loads
// the scales of the ids it holds (a gathered 4-byte load a lane, in place
// of a broadcast load a row); then for every row of the chunk the id goes
// to every lane by __shfl_sync and each reads its byte. All of a chunk's
// reads, bytes and scales, are in flight before the first add. The issue
// of the shuffles and reads sets the pace (a matrix of null-row ids, all
// L1 hits, takes nearly as long; PERF.md, section 6). Rows past the bag's
// end read row 0 and are not added; the reads stay unpredicated, as in
// fused_segment_sum.cu. (Two forms were tried and not kept, PERF.md,
// section 6: one 16-byte row a lane, its nibbles handed out by five
// shuffles a row, took 1.4-2x this form's time; 16 lanes a bag and two
// bags a warp, a byte and its two columns a lane, won only from about
// 3,000 bags, which no path of the port sends this kernel.)
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

constexpr int kThreads = 128;   // the largest block the plan asks for

// blocks an SM at the launch bound: the chunk's kDepth bytes (a register
// each), its ids and scales and the pointers fit in 64 registers up to 40
// rows, 85 up to 56 and 102 beyond, without a spill
constexpr int min_blocks(int depth) {
  return depth <= 40 ? 8 : depth <= 56 ? 6 : 5;
}

template <int kDepth>
__global__ void __launch_bounds__(kThreads, min_blocks(kDepth))
fused_int4_segment_sum_kernel(const uint8_t* __restrict__ packed,
                              const float* __restrict__ scales,
                              const int32_t* __restrict__ ids,
                              float* __restrict__ out, int n_bags, int max_l,
                              int dim, int width) {
  constexpr int kIds = (kDepth + 31) / 32;  // ids a lane holds
  const int lane = threadIdx.x & 31;
  const int64_t bag = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) +
                      (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // warp-uniform: the whole warp leaves
  const int32_t* bag_ids = ids + bag * max_l;
  for (int c0 = 0; c0 < dim; c0 += 32) {
    const int c = c0 + lane;
    const int byte = c < dim ? c >> 1 : 0;
    const int shift = 4 * (c & 1);
    float acc = 0.f;
    for (int j0 = 0; j0 < max_l; j0 += kDepth) {
      const int n = min(kDepth, max_l - j0);
      int id[kIds];
      float scale[kIds];
#pragma unroll
      for (int q = 0; q < kIds; ++q) {
        const int j = 32 * q + lane;
        id[q] = j < n ? __ldg(bag_ids + j0 + j) : 0;
        scale[q] = __ldg(scales + id[q]);
      }
      uint32_t code[kDepth];
#pragma unroll
      for (int r = 0; r < kDepth; ++r) {  // every lane shuffles and loads
        const int64_t row = __shfl_sync(0xffffffffu, id[r / 32], r % 32);
        code[r] = __ldg(packed + row * width + byte);
      }
#pragma unroll
      for (int r = 0; r < kDepth; ++r) {
        const float s = __shfl_sync(0xffffffffu, scale[r / 32], r % 32);
        const int nib = static_cast<int>((code[r] >> shift) & 0xF);
        if (r < n) {
          acc = __fadd_rn(acc, __fmul_rn(static_cast<float>(nib - 8), s));
        }
      }
    }
    if (c < dim) out[bag * dim + c] = acc;
  }
}

template <int kDepth>
int launch(const uint8_t* packed, const float* scales, const int32_t* ids,
           float* out, int n_bags, int max_l, int dim, int width, int blocks,
           int warps_per_block, cudaStream_t stream) {
  fused_int4_segment_sum_kernel<kDepth>
      <<<blocks, 32 * warps_per_block, 0, stream>>>(
          packed, scales, ids, out, n_bags, max_l, dim, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// blocks, warps_per_block and depth come from the wrapper's segment_plan;
// the grid has a warp for every bag
extern "C" int fused_int4_segment_sum_f32(const uint8_t* packed,
                                          const float* scales,
                                          const int32_t* ids, float* out,
                                          int n_bags, int max_l, int dim,
                                          int width, int blocks,
                                          int warps_per_block, int depth,
                                          cudaStream_t stream) {
  if (blocks < 1 || warps_per_block < 1 || 32 * warps_per_block > kThreads ||
      static_cast<int64_t>(blocks) * warps_per_block < n_bags) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define FISS_DEPTH(k)                                                     \
  case k:                                                                 \
    return launch<k>(packed, scales, ids, out, n_bags, max_l, dim, width, \
                     blocks, warps_per_block, stream);
  switch (depth) {
    FISS_DEPTH(8) FISS_DEPTH(16) FISS_DEPTH(24) FISS_DEPTH(32)
    FISS_DEPTH(40) FISS_DEPTH(48) FISS_DEPTH(56) FISS_DEPTH(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FISS_DEPTH
}
