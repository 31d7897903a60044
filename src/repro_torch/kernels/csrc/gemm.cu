// fp32 matrix product with fp32 accumulation, in three operand layouts:
//   NN  out(M, N) = a(M, K)   @ b(K, N)     the forward, x @ w
//   NT  out(M, N) = a(M, K)   @ b(N, K)^T   dx = g @ w^T
//   TN  out(M, N) = a(K, M)^T @ b(K, N)     dw = x^T @ g
// each read in place from contiguous storage, so the backward makes no
// transposed copies.
//
// Replaces the Pallas kernel repro/kernels/gemm.py:39 gemm (body
// _gemm_kernel, :21), the dense engine of every MLP layer; the
// reference's backward runs that kernel on transposed operands
// (repro/kernels/ops.py:60-66), which NT and TN read without a copy.
//
// Two tilings, chosen by the wrapper's plan (kernels/gemm.py, a pure
// function of M, K and N) and named by the C entry's `route` argument:
//
// 1. M <= 64 (serving buckets, the train step's forward and dx), and at
//    any M a product with K <= 64 or N <= 32 (the first and narrow
//    layers, the train step's dw): bytes and latency bound -- at M = 32
//    the six DLRM(1) layers read 1.2 MB of weights and do 2.5 MFLOP.
//    gemm_splitk_cluster_kernel: a thread-block cluster of `split` <= 8
//    blocks shares one output tile (64 rows x 32 columns; at M <= 64
//    all M rows); rank r takes the r-th slice of K
//    (`slice` deep, a multiple of 4). Each block stages its slice of a
//    and b in shared memory with cp.async (the whole slice in flight at
//    once, in 64-deep chunks), and its 128 threads each keep <= 4 rows x
//    4 columns of accumulators, summed with fmaf in order of k from 0.f.
//    The row groups (ceil(M / 16)) are a template argument, so the k
//    loop carries no branch and unrolls.
//    The partial tiles go to shared memory; after cluster.sync() rank r
//    reduces its share of the rows, reading the `split` partials through
//    distributed shared memory (map_shared_rank) in rank order 0..S-1,
//    and writes out. A second cluster.sync() keeps every block's shared
//    memory alive until its peers have read it. One launch: no
//    workspace, no atomics, no semaphore. Output (r, c) is sum over ranks
//    in rank order of (sum over the rank's slice in order of k), fixed by
//    K alone, so a row's bits do not depend on M: pipelined micro-batches
//    equal the single-shot forward bit for bit.
//    w is read exactly once across the grid. Streaming it into registers
//    instead would have the 16 row groups of a block load each row of w
//    16 times and keep only a few loads in flight; staged whole, one
//    round trip to memory brings the slice.
//
// 2. M > 64 with K > 64 and N > 32 (the 512 x 256 layers at M = 2048):
//    operation bound -- at M = 2048 those two layers do 1.07 GFLOP, 16 us
//    at the 67 TFLOP/s fp32 CUDA-core rate. gemm_tf32x3_kernel runs the
//    tensor cores at fp32 accuracy by 3xTF32 on mma.sync.m16n8k8 (tf32,
//    f32 accumulate): each operand is split as hi = rna_tf32(v) and
//    lo = rna_tf32(v - hi) (cvt.rna.tf32.f32's rounding, done in two
//    integer ops), and a k-step accumulates lo*hi, hi*lo, hi*hi, small
//    terms first; the dropped lo*lo is ~2^-22 of a product. Plain 1xTF32
//    keeps ~10 mantissa bits (error ~1e-3) and is ruled out.
//    The tensor core may truncate where it accumulates, so each 32-deep
//    k-tile sums into a fresh fragment that is then added to the tile's
//    accumulator with a round-to-nearest FADD: a truncation acts on sums
//    of 32 products, not of K. A block owns a 64 x 64 output tile (four
//    warps of 32 x 32) and walks its slice of K through a 3-stage
//    cp.async ring of 32-deep tiles, rows padded against bank conflicts,
//    the K edge zero-filled. A cluster of `split` blocks splits K when
//    the product is long or narrow (fewer output tiles than SMs), its
//    partials reduced through distributed shared memory as in 1; the
//    order is fixed by K and N, never by M, and deterministic.
//    On the H100 the fragment loads and splits, not the tensor core, set
//    this tiling's pace (PERF.md, the gemm redesign); deeper rings, more
//    warps a block splitting each k-tile and 64-deep k-tiles did not pay.
//    Why mma.sync and not wgmma: TF32 wgmma reads B only K-major from
//    shared memory; w is (K, N) row-major (N-major) and the train step
//    rewrites it every step, so a transposed copy would cost a launch per
//    layer per step. mma.sync takes its fragments through plain 32-bit
//    shared-memory loads, so NN, NT and TN all read in place.
//
// Both tilings mask every edge in the kernel (zero fill by the cp.async
// source size), so the path's ragged shapes -- K = 13 and 47, N = 1, any
// M -- need no padding; operands whose rows are not 16-byte multiples
// (K = 13, N = 1) load with 4-byte copies instead of 16-byte ones.
//
// Registers a thread (ptxas -v, sm_90a): split-K 70-86 across its 12
// instantiations (3 layouts x 4 row-group counts), tf32x3 120-123; no
// spills. chip_smoke.py phase 1 prints the report.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

enum Layout { kNN = 0, kNT = 1, kTN = 2 };

constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy `bytes` (0..16) of src and zero the rest of the 16-byte dst
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// s[r * P + c] = g[(r0 + r) * ld + c0 + c] for r < fr, c < fc (fc a
// multiple of 4), zero where r0 + r >= rows or c0 + c >= cols. `vec`
// (ld a multiple of 4, g 16-byte aligned, c0 a multiple of 4) takes
// 16-byte copies, else 4-byte ones.
template <int P, int kThreads>
__device__ __forceinline__ void load_tile(float* s, const float* g, int ld,
                                          int rows, int cols, int r0,
                                          int c0, int fr, int fc, bool vec) {
  if (vec) {
    const int chunks = fc / 4;
    for (int i = threadIdx.x; i < fr * chunks; i += kThreads) {
      const int r = i / chunks, c = (i % chunks) * 4;
      const int gr = r0 + r, gc = c0 + c;
      const int valid = gr < rows ? min(max(cols - gc, 0), 4) : 0;
      cp_async16(s + r * P + c,
                 valid ? g + static_cast<int64_t>(gr) * ld + gc : g,
                 valid * 4);
    }
  } else {
    for (int i = threadIdx.x; i < fr * fc; i += kThreads) {
      const int r = i / fc, c = i % fc;
      const int gr = r0 + r, gc = c0 + c;
      const bool ok = gr < rows && gc < cols;
      cp_async4(s + r * P + c,
                ok ? g + static_cast<int64_t>(gr) * ld + gc : g, ok ? 4 : 0);
    }
  }
}

constexpr int kMaxSplit = 8;  // blocks of a cluster: the portable size

// Sum the cluster's partial tiles -- `rows` x kCols floats at pitch
// kPitch in each block's shared memory, `part` -- in rank order into out
// rows [row0, row0 + rows) x cols [col0, col0 + kCols), masked to m x n
// (a narrow product reads only its columns).
// Rank r reduces the r-th share of the rows, reading its peers' tiles
// through distributed shared memory. The first barrier has every partial
// written before any is read, the second every read done before any
// block exits (a peer's shared memory lives only as long as its block).
template <int kCols, int kPitch, int kThreads>
__device__ __forceinline__ void cluster_reduce(cg::cluster_group& cluster,
                                               float* part, int rows,
                                               float* __restrict__ out, int m,
                                               int n, int row0, int col0) {
  cluster.sync();
  const int split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int per = (rows + split - 1) / split;
  const int r_lo = min(rows, rank * per), r_hi = min(rows, r_lo + per);
  const int cols = min(kCols, n - col0);  // the tile's columns inside n
  for (int idx = threadIdx.x; idx < (r_hi - r_lo) * cols; idx += kThreads) {
    const int r = r_lo + idx / cols, c = idx % cols;
    float v[kMaxSplit];
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s)
      if (s < split) v[s] = cluster.map_shared_rank(part, s)[r * kPitch + c];
    float sum = v[0];
#pragma unroll
    for (int s = 1; s < kMaxSplit; ++s)
      if (s < split) sum = __fadd_rn(sum, v[s]);
    if (row0 + r < m)
      out[static_cast<int64_t>(row0 + r) * n + col0 + c] = sum;
  }
  cluster.sync();
}

template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, dim3 grid, dim3 cluster, int threads,
                   int smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : last);
}

// ------------------------------------------------ 1. cluster split-K

constexpr int kSkRows = 64;     // rows of a block's tile
constexpr int kSkCols = 32;     // output columns of a cluster
constexpr int kSkChunk = 64;    // k staged at once
constexpr int kSkThreads = 128; // 8 column quads x 16 row groups
constexpr int kSkPitchX = 68;   // 64 + 4: 16-byte rows, no bank conflicts
constexpr int kSkPitchW = kSkCols + 4;
constexpr int kSkPitchP = kSkCols + 1;

// G = ceil(M / 16) row groups, a template argument so that the k loop
// carries no branch and unrolls
template <int L, int G>
__global__ void __launch_bounds__(kSkThreads)
    gemm_splitk_cluster_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ out, int m, int n, int k,
                               int slice, bool vec_a, bool vec_b) {
  // x: [row][k] (NN, NT) or [k][row] (TN); w: [k][col] (NN, TN) or
  // [col][k] (NT); both kSkChunk deep
  __shared__ __align__(16) float xs[kSkChunk * kSkPitchX];
  __shared__ __align__(16) float ws[kSkChunk * kSkPitchW];
  __shared__ float part[kSkRows * kSkPitchP];
  static_assert(kSkCols * kSkPitchX <= kSkChunk * kSkPitchW, "ws");

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int col0 = blockIdx.y * kSkCols;
  const int row0 = blockIdx.z * kSkRows;
  const int rows = min(kSkRows, m - row0);
  const int q = threadIdx.x % 8;    // columns q*4..q*4+3 (NT: q + 8j)
  const int rg = threadIdx.x / 8;   // rows rg + 16 i
  constexpr int groups = G;         // i < groups hold rows
  // columns of w worth loading; the ones past them only feed outputs
  // past n, which are never stored
  const int cols = min(kSkCols, (n - col0 + 3) & ~3);
  const int k_lo = min(k, rank * slice);
  const int k_hi = min(k, k_lo + slice);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = k_lo; c0 < k_hi; c0 += kSkChunk) {
    const int kc = (min(kSkChunk, k_hi - c0) + 3) & ~3;  // zero past k_hi
    if (L == kTN)  // a (K, M)
      load_tile<kSkPitchX, kSkThreads>(xs, a, m, k_hi, m, c0, row0, kc,
                                       groups * 16, vec_a);
    else           // a (M, K)
      load_tile<kSkPitchX, kSkThreads>(xs, a, k, m, k_hi, row0, c0,
                                       groups * 16, kc, vec_a);
    if (L == kNT)  // b (N, K)
      load_tile<kSkPitchX, kSkThreads>(ws, b, k, n, k_hi, col0, c0, cols,
                                       kc, vec_b);
    else           // b (K, N)
      load_tile<kSkPitchW, kSkThreads>(ws, b, n, k_hi, n, c0, col0, kc,
                                       cols, vec_b);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kc; kk += 4) {
      float wv[4][4];  // [k][column]
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (L == kNT) {
          const float4 v = *reinterpret_cast<const float4*>(
              ws + (q + 8 * j) * kSkPitchX + kk);
          wv[0][j] = v.x; wv[1][j] = v.y; wv[2][j] = v.z; wv[3][j] = v.w;
        } else {
          const float4 v = *reinterpret_cast<const float4*>(
              ws + (kk + j) * kSkPitchW + q * 4);
          wv[j][0] = v.x; wv[j][1] = v.y; wv[j][2] = v.z; wv[j][3] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i < groups) {
          const int r = rg + 16 * i;
          float xv[4];
          if (L == kTN) {
#pragma unroll
            for (int j = 0; j < 4; ++j) xv[j] = xs[(kk + j) * kSkPitchX + r];
          } else {
            const float4 v =
                *reinterpret_cast<const float4*>(xs + r * kSkPitchX + kk);
            xv[0] = v.x; xv[1] = v.y; xv[2] = v.z; xv[3] = v.w;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[i][c] = fmaf(xv[j], wv[j][c], acc[i][c]);
        }
      }
    }
    __syncthreads();  // the next chunk overwrites xs and ws
  }

  const bool direct = cluster.num_blocks() == 1;  // nothing to reduce
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i < groups) {
      const int r = rg + 16 * i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = L == kNT ? q + 8 * c : q * 4 + c;
        if (!direct)
          part[r * kSkPitchP + col] = acc[i][c];
        else if (r < rows && col0 + col < n)
          out[static_cast<int64_t>(row0 + r) * n + col0 + col] = acc[i][c];
      }
    }
  }
  if (!direct)
    cluster_reduce<kSkCols, kSkPitchP, kSkThreads>(cluster, part, rows, out,
                                                   m, n, row0, col0);
}

template <int L, int G>
int launch_splitk_rows(const float* a, const float* b, float* out, int m,
                       int n, int k, int split, int slice, bool vec_a,
                       bool vec_b, cudaStream_t stream) {
  return launch_cluster(gemm_splitk_cluster_kernel<L, G>,
                        dim3(split, (n + kSkCols - 1) / kSkCols,
                             (m + kSkRows - 1) / kSkRows),
                        dim3(split, 1, 1), kSkThreads, 0, stream, a, b, out,
                        m, n, k, slice, vec_a, vec_b);
}

template <int L>
int launch_splitk(const float* a, const float* b, float* out, int m, int n,
                  int k, int split, int slice, bool vec_a, bool vec_b,
                  cudaStream_t stream) {
  if (slice % 4) return static_cast<int>(cudaErrorInvalidValue);
  switch ((min(m, kSkRows) + 15) / 16) {
    case 1:
      return launch_splitk_rows<L, 1>(a, b, out, m, n, k, split, slice,
                                      vec_a, vec_b, stream);
    case 2:
      return launch_splitk_rows<L, 2>(a, b, out, m, n, k, split, slice,
                                      vec_a, vec_b, stream);
    case 3:
      return launch_splitk_rows<L, 3>(a, b, out, m, n, k, split, slice,
                                      vec_a, vec_b, stream);
    default:
      return launch_splitk_rows<L, 4>(a, b, out, m, n, k, split, slice,
                                      vec_a, vec_b, stream);
  }
}

// ------------------------------------------------ 2. 3xTF32 mma.sync

constexpr int kTcM = 64, kTcN = 64, kTcK = 32;
constexpr int kTcStages = 3;
constexpr int kTcThreads = 128;           // 2 x 2 warps of 32 x 32
constexpr int kTcPitchRow = kTcK + 4;     // [row][k]: g * 4 + t banks
constexpr int kTcPitchCol = kTcM + 8;     // [k][row]: t * 8 + g banks
constexpr int kTcTile = kTcM * kTcPitchRow > kTcK * kTcPitchCol
                            ? kTcM * kTcPitchRow : kTcK * kTcPitchCol;
static_assert(kTcM == kTcN && kTcPitchRow % 32 == 4, "tile layout");
constexpr int kTcStage = 2 * kTcTile;     // a tile, then b tile
constexpr int kTcSmemBytes = kTcStages * kTcStage * 4;  // 55,296
constexpr int kTcPitchP = kTcN + 1;
// after the main loop the ring holds the block's partial tile
static_assert(kTcM * kTcPitchP <= kTcStages * kTcStage, "ring");

// cvt.rna.tf32.f32 in two integer ops: round the magnitude half away from
// zero at bit 13 and clear the 13 bits TF32 drops. The result keeps the
// fp32 bit pattern, so v - hi is exact.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A block owns a 64 x 64 output tile; warp w the 32 x 32 sub-tile at
// (wm, wn). Cluster rank r takes K's r-th `slice` (a multiple of
// 32); a cluster of one writes its tile directly.
template <int L>
__global__ void __launch_bounds__(kTcThreads)
    gemm_tf32x3_kernel(const float* __restrict__ a,
                       const float* __restrict__ b, float* __restrict__ out,
                       int m, int n, int k, int slice, bool vec_a,
                       bool vec_b) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kAT = L == kTN;  // a stored (K, M): tile [k][row]
  constexpr bool kBT = L == kNT;  // b stored (N, K): tile [col][k]
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment coordinates
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int row0 = blockIdx.y * kTcM, col0 = blockIdx.x * kTcN;
  const int k_lo = min(k, rank * slice);
  const int k_hi = min(k, k_lo + slice);
  const int tiles = (k_hi - k_lo + kTcK - 1) / kTcK;

  auto load_stage = [&](int j) {
    float* as = smem + (j % kTcStages) * kTcStage;
    float* bs = as + kTcTile;
    const int k0 = k_lo + j * kTcK;
    if (kAT)
      load_tile<kTcPitchCol, kTcThreads>(as, a, m, k_hi, m, k0, row0, kTcK,
                                         kTcM, vec_a);
    else
      load_tile<kTcPitchRow, kTcThreads>(as, a, k, m, k_hi, row0, k0, kTcM,
                                         kTcK, vec_a);
    if (kBT)
      load_tile<kTcPitchRow, kTcThreads>(bs, b, k, n, k_hi, col0, k0, kTcN,
                                         kTcK, vec_b);
    else
      load_tile<kTcPitchCol, kTcThreads>(bs, b, n, k_hi, n, k0, col0, kTcK,
                                         kTcN, vec_b);
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < tiles) load_stage(s);
    cp_async_commit();
  }
  for (int jt = 0; jt < tiles; ++jt) {
    cp_async_wait<kTcStages - 2>();
    __syncthreads();  // tile jt landed; tile jt - 1's slot is free
    if (jt + kTcStages - 1 < tiles) load_stage(jt + kTcStages - 1);
    cp_async_commit();
    const float* as = smem + (jt % kTcStages) * kTcStage;
    const float* bs = as + kTcTile;
    // the tensor core may truncate as it accumulates: each tile's
    // products sum into a fresh fragment, added to acc with a
    // round-to-nearest FADD
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kTcK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
          const int rr = r + (e & 1) * 8, kx = kk + t + (e >> 1) * 4;
          const float v =
              kAT ? as[kx * kTcPitchCol + rr] : as[rr * kTcPitchRow + kx];
          split_tf32(v, ah[i][e], al[i][e]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // b0 (k t, col g), b1 (k t + 4, col g)
          const int kx = kk + t + e * 4;
          const float v =
              kBT ? bs[c * kTcPitchRow + kx] : bs[kx * kTcPitchCol + c];
          split_tf32(v, bh[j][e], bl[j][e]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_tf32(part[i][j], al[i], bh[j]);
          mma_tf32(part[i][j], ah[i], bl[j]);
          mma_tf32(part[i][j], ah[i], bh[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  const bool direct = cluster.num_blocks() == 1;  // nothing to reduce
  float* ptile = smem;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
        const int r = wm + i * 16 + g + (e >> 1) * 8;
        const int c = wn + j * 8 + 2 * t + (e & 1);
        if (!direct)
          ptile[r * kTcPitchP + c] = acc[i][j][e];
        else if (row0 + r < m && col0 + c < n)
          out[static_cast<int64_t>(row0 + r) * n + col0 + c] = acc[i][j][e];
      }
  if (!direct)
    cluster_reduce<kTcN, kTcPitchP, kTcThreads>(cluster, ptile, kTcM, out, m,
                                                n, row0, col0);
}

// raise the kernel's dynamic shared memory limit, once a device
template <int L>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(gemm_tf32x3_kernel<L>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTcSmemBytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <int L>
int launch_tc(const float* a, const float* b, float* out, int m, int n,
              int k, int split, int slice, bool vec_a, bool vec_b,
              cudaStream_t stream) {
  if (slice % kTcK) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t attr = allow_smem<L>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return launch_cluster(gemm_tf32x3_kernel<L>,
                        dim3((n + kTcN - 1) / kTcN, (m + kTcM - 1) / kTcM,
                             split),
                        dim3(1, 1, split), kTcThreads, kTcSmemBytes, stream,
                        a, b, out, m, n, k, slice, vec_a, vec_b);
}

bool aligned16(const float* p, int ld) {
  return ld % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int L>
int launch(const float* a, const float* b, float* out, int m, int n, int k,
           int route, int split, int slice, cudaStream_t stream) {
  const bool vec_a = aligned16(a, L == kTN ? m : k);
  const bool vec_b = aligned16(b, L == kNT ? k : n);
  return route == 0 ? launch_splitk<L>(a, b, out, m, n, k, split, slice,
                                       vec_a, vec_b, stream)
                    : launch_tc<L>(a, b, out, m, n, k, split, slice, vec_a,
                                   vec_b, stream);
}

}  // namespace

// out (m, n) = a @ b in `layout` (0 NN: a (m, k), b (k, n); 1 NT: a (m,
// k), b (n, k); 2 TN: a (k, m), b (k, n)), all fp32 and contiguous.
// route 0: the cluster split-K tiling, each of `split` blocks `slice`
// deep (a multiple of 4); route 1: the 3xTF32 tiling, clusters of
// `split` blocks along K, each `slice` deep (a multiple of 32). split in
// 1..8 and split * slice >= k. Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernels do not take.
extern "C" int gemm_f32(const float* a, const float* b, float* out, int m,
                        int n, int k, int layout, int route, int split,
                        int slice, cudaStream_t stream) {
  if (m < 1 || n < 1 || k < 1 || route < 0 || route > 1 || split < 1 ||
      split > kMaxSplit || slice < 1 ||
      static_cast<int64_t>(split) * slice < k)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (layout) {
    case kNN:
      return launch<kNN>(a, b, out, m, n, k, route, split, slice, stream);
    case kNT:
      return launch<kNT>(a, b, out, m, n, k, route, split, slice, stream);
    case kTN:
      return launch<kTN>(a, b, out, m, n, k, route, split, slice, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
