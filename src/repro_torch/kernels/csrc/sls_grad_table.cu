// Segment scatter-add, the table gradient of a ragged gather-reduce:
//   out[r, :] = sum over sorted positions p with dst[p] == r of
//               g[bag[p], :]                                    (f32)
//
// Replaces the Pallas kernel repro/kernels/embedding_gather.py:188
// sls_grad_table (body _grad_kernel, :164). As there, the wrapper sorts
// the positions by destination row (stably, so each run keeps ascending
// position order) and hands over the zeroed output; padded positions
// carry the destination n_rows and are skipped.
//
// Bound: bytes. Each step reads one upstream bag-gradient row (D * 4
// bytes, 128 B at D = 32) at a data-dependent address and adds it: one
// add per 4 bytes read. The (n_rows, D) zero fill, done by the wrapper,
// moves far more bytes than the kernel whenever n_rows >> N.
//
// Design: the TPU walks the sorted positions one grid step at a time and
// carries a run's sum in VMEM from step to step. Blocks here run in no
// order, so each run is owned by one warp instead: one warp per sorted
// position, and only the warp at the start of a run (p == 0 or
// dst[p - 1] != dst[p]) acts. It walks its run in ascending position
// order with lanes over D, reading 32 positions' bag ids at a time and
// broadcasting them with __shfl_sync, keeps the sum in a register and
// writes the row once. No float atomics and no host sync: two launches
// give the same bits, and the sum equals the CPU's index_add_, which
// adds in the same order. The g rows of a batch of positions are loaded
// before they are added, so a long run (a Zipf-hot row) keeps several
// loads in flight while its adds stay in order. skip_row (-1 for none)
// names a row whose run is left at zero without being walked: the null
// row of the dense id form, whose gradient the reference pins to zero.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kBatch = 8;  // g rows loaded before they are added

__global__ void sls_grad_table_kernel(const float* __restrict__ g,
                                      const int32_t* __restrict__ dst,
                                      const int32_t* __restrict__ bag,
                                      float* __restrict__ out, int n,
                                      int n_rows, int dim, int skip_row) {
  const unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= n) return;  // every early return is warp-uniform
  const int row = dst[p];
  if (row < 0 || row >= n_rows || row == skip_row) return;
  if (p > 0 && dst[p - 1] == row) return;  // not the start of a run
  float* out_row = out + static_cast<int64_t>(row) * dim;
  for (int d0 = 0; d0 < dim; d0 += 32) {
    const int d = d0 + lane;
    float acc = 0.f;
    for (int q0 = p; q0 < n; q0 += 32) {
      const int q = q0 + lane;
      const bool in_run = q < n && dst[q] == row;
      const int my_bag = in_run ? bag[q] : 0;
      // dst is sorted, so the lanes still in the run are a prefix
      const int count = __popc(__ballot_sync(kAll, in_run));
      for (int j0 = 0; j0 < count; j0 += kBatch) {
        float v[kBatch];
#pragma unroll
        for (int jj = 0; jj < kBatch; ++jj) {
          const int64_t src = __shfl_sync(kAll, my_bag, (j0 + jj) & 31);
          v[jj] = (j0 + jj < count && d < dim) ? g[src * dim + d] : 0.f;
        }
#pragma unroll
        for (int jj = 0; jj < kBatch; ++jj)
          if (j0 + jj < count) acc += v[jj];
      }
      if (count < 32) break;
    }
    if (d < dim) out_row[d] = acc;
  }
}

}  // namespace

extern "C" int sls_grad_table_f32(const float* g, const int32_t* dst,
                                  const int32_t* bag, float* out, int n,
                                  int n_rows, int dim, int skip_row,
                                  cudaStream_t stream) {
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sls_grad_table_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      g, dst, bag, out, n, n_rows, dim, skip_row);
  return static_cast<int>(cudaGetLastError());
}
