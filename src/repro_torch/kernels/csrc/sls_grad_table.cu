// Segment scatter-add, the table gradient of a ragged gather-reduce:
//   out[r, :] = sum over valid positions p with ids[p] == r of
//               g[bag(p), :]                                     (f32)
// each row summed in ascending position order from 0.f; rows no valid
// position names, and skip_row, are zero. A position p is valid when
// p < offsets[n_bags]; bag(p) is the number of b in [1, n_bags] with
// offsets[b] <= p, at most n_bags - 1 (torch.searchsorted(offsets[1:],
// p, right=True), clamped).
//
// Replaces the Pallas kernel repro/kernels/embedding_gather.py:188
// sls_grad_table (body _grad_kernel, :164). There the wrapper argsorts
// the positions by destination; one sequential grid walks them, carries
// a run's sum in VMEM and flushes it once, into a zero table aliased
// onto the output, so only the rows a run visits are written.
//
// Bound: bytes, and at the training path's shapes the output write
// alone: n_rows * D * 4 bytes (128 MB for 1,000,001 x 32, 0.038 ms at
// 3.35 TB/s) against a few MB of ids, offsets and g rows; one add per 4
// bytes of g read. What sets the pace past the output write is the
// longest run (a Zipf-hot row): its adds are one chain.
//
// Design. Blocks run in no order here, so nothing carries from one to
// the next; instead each block of the main kernel owns a fixed set of
// output rows and is the only writer of them. The rows are cut into
// granules of 2^granule_log rows (512 bytes: 4 rows at D = 32), and
// block q of 2^block_log owns the granules g with g % 2^block_log == q:
// a Zipf head -- a table's first rows -- spreads over several blocks
// instead of piling onto the one that owns the table's first range.
//
// 1. Up to kScanMax positions every block tests every id itself. Past
//    it, sls_grad_partition_kernel reads each tile of kTile positions
//    once, finds each valid position's owner block and bag (a block-wide
//    search of offsets for the tile's first bag, then each lane walks a
//    window of offsets staged in shared memory: the wrapper's
//    searchsorted, moved in here) and splits the tile stably by owner:
//    each warp ranks its rounds of 32 positions with __match_any_sync and
//    per-warp counters, so a block's entries keep position order. It
//    writes the entries (local row, bag) and, per tile and block, their
//    count and start. Without it every block would read every id: 128 x
//    1.6 MB of L2 reads at 409,600 positions, slower than the whole
//    rest.
// 2. sls_grad_table_kernel, one block per owner, 16 warps:
//    - the 12 compute warps gather the block's entries tile by tile, in
//      position order, into a shared-memory chunk of at most 2^chunk_log
//      (whole tiles at a time), mark every row the block's positions
//      touch in a bitmap, and sort the chunk by local row with a stable
//      radix sort (two 8-bit digits, each pass ranked like the
//      partition): position order within a row is kept. Then the sorted
//      entries' g rows stream through a ring of kStages shared-memory
//      tiles filled by cp.async, so a hot run keeps a tile ring of loads
//      in flight, while a group of lanes (16 bytes a lane) sums each run
//      in order and writes its row once. A run crossing a tile carries
//      its sum in shared memory; a run crossing a chunk (a block with
//      more entries than a chunk holds) carries it through the output:
//      the next chunk reads back what the last one wrote and goes on
//      adding.
//    - the 4 sweep warps wait for the bitmap, then write zeros, 16 bytes
//      a store, to every row of the block's set that no position
//      touches, while the compute warps sort and sum; the compute warps
//      join the sweep when their chunks are done. The sweep is the
//      output write that bounds the kernel, and it never meets a row the
//      sums write.
// So every output row is written by its owner -- once, unless its run
// crosses a chunk -- and the wrapper needs no fill of its own. No float
// atomics (the counters and bitmaps are integers), no host sync: two
// launches give the same bits, and every row equals the CPU's
// index_add_, which adds the same terms in the same order from +0.0.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 512;  // a block of either kernel
constexpr int kWarps = kThreads / 32;
constexpr int kComputeWarps = 12;
constexpr int kCompute = kComputeWarps * 32;
constexpr int kTile = 4096;                // positions a partition block
constexpr int kScanMax = 8192;            // positions every block scans
// positions of a tile a compute thread tests when blocks scan the ids
constexpr int kPerThread = (kTile + kCompute - 1) / kCompute;
constexpr int kRounds = kTile / kThreads;  // rounds of 32 a warp
constexpr int kStages = 4;                 // g tiles in flight
constexpr int kWindow = 4096;              // offsets a partition block stages
constexpr int kDigitBits = 8;              // the chunk sort's radix
constexpr int kDigits = 1 << kDigitBits;
constexpr int kMaxChunkLog = 12;
// rounds of 32 entries a compute warp takes in one pass of the sort
constexpr int kSortRounds =
    ((1 << kMaxChunkLog) + 32 * kComputeWarps - 1) / (32 * kComputeWarps);
constexpr int kMaxBlocks = 2048;
constexpr int kMaxRowsPerBlock = 1 << 15;  // two 4 KB bitmaps
constexpr int kMaxPositions = 2147483647 - kTile;
constexpr int kScratch = 40;  // words of scratch: warp totals, counters
constexpr int kMaxSmem = 232448;
constexpr int kMaxDevices = 64;
constexpr int kGatherPer = (1 << kMaxChunkLog) / kCompute + 1;  // a thread
constexpr int kClaimBytes = 8192;  // zeros a sweeping warp claims at once
// named barriers of the main kernel (0 is __syncthreads)
constexpr int kBarCompute = 1;    // the compute warps among themselves
constexpr int kBarCollected = 2;  // the touched-row bitmap is complete

static_assert(kTile % kThreads == 0, "a warp takes whole rounds of 32");

struct Args {
  const float* g;
  const int32_t* ids;
  const int32_t* offsets;
  float* out;
  int2* entries;    // (local row, bag) of every kept position
  int* tile_count;  // [tile][block]: the block's entries in the tile
  int* tile_start;  // [tile][block]: where they start in the tile
  int n, n_bags, n_rows, dim, skip_row;
  int n_tiles;    // tiles of kTile positions
  int partition;  // 0: no partition kernel, each block scans the ids
  int block_log, granule_log, chunk_log, tile, rows_per_block;
  // ceil(2^32 / unit), unit = dim / 4 for 16-byte copies, else dim:
  // div_unit(i) == i / unit for the small i it is used on
  uint64_t magic;
  int vec;  // g and out moved 16 bytes at a time (dim % 4 == 0)
};

int64_t smem_words(int dim, int chunk, int tile, int rows_per_block) {
  return static_cast<int64_t>(kStages) * tile * dim  // g tiles
         + 2LL * dim                    // run carries
         + 4LL * chunk                  // keys and bags, twice (the sort)
         + kComputeWarps * kDigits      // the sort's per-warp counters
         + 2LL * ((rows_per_block + 31) / 32)  // touched, written
         + 2LL * kCompute               // tiles gathered
         + kScratch;
}

int64_t partition_smem_words(int blocks) {
  return static_cast<int64_t>(kWarps + 2) * blocks + kWindow + kScratch;
}

__device__ __forceinline__ int div_unit(const Args& a, int i) {
  return static_cast<int>((static_cast<uint64_t>(i) * a.magic) >> 32);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the oldest of the kStages groups in flight has landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
}

// Exclusive prefix of v over the first kGroup threads of the block, which
// meet at barrier `bar`; `total` gets the sum. Leaves `warp_sums` free for
// the next call.
template <int kGroup>
__device__ __forceinline__ int group_scan(int v, int* warp_sums, int& total,
                                          int bar) {
  constexpr int kGroupWarps = kGroup / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  bar_sync(bar, kGroup);
  if (warp == 0) {
    int w = lane < kGroupWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kGroupWarps) warp_sums[lane] = w;
  }
  bar_sync(bar, kGroup);
  const int before = warp ? warp_sums[warp - 1] : 0;
  total = warp_sums[kGroupWarps - 1];
  bar_sync(bar, kGroup);
  return before + x - v;
}

// The number of off1[0 .. n_bags) that are <= p (off1 = offsets + 1,
// ascending), given that the first `seg` of them are: a short walk from
// the previous position's answer, then a binary search.
__device__ __forceinline__ int count_le(const int32_t* __restrict__ off1,
                                        int n_bags, int p, int seg) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (seg >= n_bags || __ldg(off1 + seg) > p) return seg;
    ++seg;
  }
  int hi = n_bags;
  while (seg < hi) {
    const int mid = (seg + hi) >> 1;
    if (__ldg(off1 + mid) <= p)
      seg = mid + 1;
    else
      hi = mid;
  }
  return seg;
}

__device__ __forceinline__ int64_t global_row(const Args& a, int local) {
  const int64_t gran =
      (static_cast<int64_t>(local >> a.granule_log) << a.block_log) |
      blockIdx.x;
  return (gran << a.granule_log) | (local & ((1 << a.granule_log) - 1));
}

// The block's local index of `row`, or -1 when another block owns it,
// it lies outside [0, n_rows) or it is skip_row.
__device__ __forceinline__ int local_row(const Args& a, int row) {
  if (static_cast<unsigned>(row) >= static_cast<unsigned>(a.n_rows) ||
      row == a.skip_row)
    return -1;
  const unsigned gran = static_cast<unsigned>(row) >> a.granule_log;
  if ((gran & ((1u << a.block_log) - 1)) != blockIdx.x) return -1;
  return static_cast<int>(((gran >> a.block_log) << a.granule_log) |
                          (row & ((1 << a.granule_log) - 1)));
}

// ------------------------------------------------------------- partition

// The number of off1[0 .. n) that are <= x (off1 ascending), found by the
// whole block: each round samples kThreads evenly spaced entries of the
// range still open, so it narrows the range kThreads-fold a round (two
// rounds at 409,600 bags) instead of one load a step.
__device__ int block_count_le(const int32_t* __restrict__ off1, int n,
                              int x) {
  int lo = 0, hi = n;  // off1[< lo] <= x < off1[>= hi]
  while (lo < hi) {
    const int stride = (hi - lo + kThreads - 1) / kThreads;
    const int i = lo + static_cast<int>(threadIdx.x) * stride;
    const int below = __syncthreads_count(i < hi && __ldg(off1 + i) <= x);
    if (below == 0) break;
    const int next = lo + below * stride;  // the first sample above x
    lo += (below - 1) * stride + 1;
    hi = min(hi, next);
  }
  return lo;
}

// The number of win[0 .. n) that are <= p (win ascending), given that the
// first k of them are: a short walk from the lane's previous answer, then
// a binary search.
__device__ __forceinline__ int window_count_le(const int32_t* win, int n,
                                               int p, int k) {
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (k >= n || win[k] > p) return k;
    ++k;
  }
  int hi = n;
  while (k < hi) {
    const int mid = (k + hi) >> 1;
    if (win[mid] <= p)
      k = mid + 1;
    else
      hi = mid;
  }
  return k;
}

__global__ void __launch_bounds__(kThreads)
    sls_grad_partition_kernel(const Args a) {
  extern __shared__ int psmem[];
  const int blocks = 1 << a.block_log;
  int* counts = psmem;                     // [warp][block], then bases
  int* totals = counts + kWarps * blocks;  // [block]
  int* starts = totals + blocks;           // [block]
  int* win = starts + blocks;              // offsets[b0 + 1 ...]
  int* scratch = win + kWindow;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile0 = blockIdx.x * kTile;
  const int n_valid =
      a.n_bags > 0 ? max(0, min(a.n, __ldg(a.offsets + a.n_bags))) : 0;
  const int32_t* off1 = a.offsets + 1;
  // every round's id in flight at once (the rounds' warp syncs would
  // otherwise wait for each load in turn), overlapping the search below
  const int p0 = tile0 + warp * (kRounds * 32) + lane;
  int ids[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    ids[r] = p0 + r * 32 < a.n ? __ldg(a.ids + p0 + r * 32) : -1;
  for (int i = tid; i < kWarps * blocks; i += kThreads) counts[i] = 0;
  // the bags of the tile's positions: b0 of them end at or before the
  // tile's first position, and the next kWindow bag ends are staged
  const int b0 = tile0 < n_valid ? block_count_le(off1, a.n_bags, tile0) : 0;
  const int n_win = tile0 < n_valid ? min(kWindow, a.n_bags - b0) : 0;
  for (int i = tid; i < n_win; i += kThreads) win[i] = __ldg(off1 + b0 + i);
  __syncthreads();

  int owner[kRounds], rank[kRounds], local[kRounds], bag[kRounds];
  int seg = 0;  // bag ends in the window at or before the lane's position
  int* mine = counts + warp * blocks;
#pragma unroll
  for (int r = 0; r < kRounds; ++r) {
    const int p = p0 + r * 32;
    const int row = p < n_valid ? ids[r] : -1;
    owner[r] = -1;
    if (static_cast<unsigned>(row) < static_cast<unsigned>(a.n_rows) &&
        row != a.skip_row) {
      const unsigned gran = static_cast<unsigned>(row) >> a.granule_log;
      owner[r] = static_cast<int>(gran & (blocks - 1));
      local[r] = static_cast<int>(((gran >> a.block_log) << a.granule_log) |
                                  (row & ((1 << a.granule_log) - 1)));
      seg = window_count_le(win, n_win, p, seg);
      // past the window only when more than kWindow bags end in the tile
      const int ends = seg < n_win ? b0 + seg
                                   : count_le(off1, a.n_bags, p, b0 + seg);
      bag[r] = min(ends, a.n_bags - 1);
    }
    // rank among this warp's earlier positions with the same owner
    const unsigned same = __match_any_sync(0xffffffffu, owner[r]);
    if (owner[r] >= 0)
      rank[r] = mine[owner[r]] + __popc(same & ((1u << lane) - 1));
    __syncwarp();
    if (owner[r] >= 0 && 31 - __clz(same) == lane)
      mine[owner[r]] += __popc(same);
    __syncwarp();
  }
  __syncthreads();
  // per owner: each warp's base in the tile, the tile's count, the start
  for (int b = tid; b < blocks; b += kThreads) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = counts[w * blocks + b];
      counts[w * blocks + b] = run;
      run += c;
    }
    totals[b] = run;
  }
  __syncthreads();
  const int per = (blocks + kThreads - 1) / kThreads;
  const int c0 = min(blocks, tid * per), c1 = min(blocks, c0 + per);
  int sum = 0;
  for (int b = c0; b < c1; ++b) sum += totals[b];
  int all;
  int before = group_scan<kThreads>(sum, scratch, all, 0);
  for (int b = c0; b < c1; ++b) {
    const int64_t at = static_cast<int64_t>(blockIdx.x) * blocks + b;
    starts[b] = before;
    a.tile_count[at] = totals[b];
    a.tile_start[at] = before;
    before += totals[b];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    if (owner[r] >= 0)
      a.entries[tile0 + starts[owner[r]] + mine[owner[r]] + rank[r]] =
          make_int2(local[r], bag[r]);
}

// ------------------------------------------------------------ main kernel

// Zeros to every row of the block's set that no position touches,
// kClaimBytes of granules at a time, claimed from a shared counter: the
// sweep warps start on it as soon as the bitmap is complete, and the
// compute warps join when they are done with their chunks.
__device__ void sweep(const Args& a, const uint32_t* touched, int* claim) {
  const int lane = threadIdx.x & 31;
  // the block's granules that start inside the table
  const int64_t all = (static_cast<int64_t>(a.n_rows) +
                       (1 << a.granule_log) - 1) >> a.granule_log;
  const int granules = static_cast<int>(
      (all - blockIdx.x + (1 << a.block_log) - 1) >> a.block_log);
  const int unit = a.vec ? a.dim >> 2 : a.dim;
  const int per_granule = unit << a.granule_log;
  const int per_claim = max(1, kClaimBytes / (a.dim * 4 << a.granule_log));
  while (true) {
    int first = lane == 0 ? atomicAdd(claim, per_claim) : 0;
    first = __shfl_sync(0xffffffffu, first, 0);
    const int last = min(granules, first + per_claim);
    if (first >= last) return;
    for (int f = lane; f < per_granule; f += 32) {  // once at D = 32
      const int r = div_unit(a, f);  // the row of the granule
      for (int lg = first; lg < last; ++lg) {
        const int64_t row0 =
            ((static_cast<int64_t>(lg) << a.block_log) | blockIdx.x)
            << a.granule_log;
        const int local = (lg << a.granule_log) + r;
        if (row0 + r >= a.n_rows ||
            ((touched[local >> 5] >> (local & 31)) & 1u))
          continue;
        // streaming stores: the 128 MB should not push the g rows that
        // every block reads out of the L2
        if (a.vec)
          __stcs(reinterpret_cast<float4*>(a.out) + row0 * unit + f,
                 make_float4(0.f, 0.f, 0.f, 0.f));
        else
          __stcs(a.out + row0 * unit + f, 0.f);
      }
    }
  }
}

// One stable pass of the chunk's radix sort by local row: digit `shift`
// of each key, from (kin, bin) to (kout, bout). Each compute warp takes
// a contiguous stretch of entries in rounds of 32 and ranks each entry
// among its warp's earlier ones of the same digit (__match_any_sync and
// per-warp counters); the counters, scanned over warps and digits, place
// every entry after all earlier ones of its digit.
__device__ void sort_pass(const uint32_t* kin, const int32_t* bin,
                          uint32_t* kout, int32_t* bout, int count,
                          int shift, int* counters, int* scratch) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < kComputeWarps * kDigits; i += kCompute)
    counters[i] = 0;
  bar_sync(kBarCompute, kCompute);
  const int per = (count + kComputeWarps - 1) / kComputeWarps;
  const int rounds = (per + 31) / 32;
  const int e0 = warp * per, e1 = min(count, e0 + per);
  int* mine = counters + warp * kDigits;
  int digit[kSortRounds], rank[kSortRounds];
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    if (r >= rounds) break;  // the same for every warp
    const int e = e0 + r * 32 + lane;
    digit[r] = e < e1 ? static_cast<int>((kin[e] >> shift) & (kDigits - 1))
                      : -1;
    const unsigned same = __match_any_sync(0xffffffffu, digit[r]);
    if (digit[r] >= 0)
      rank[r] = mine[digit[r]] + __popc(same & ((1u << lane) - 1));
    __syncwarp();
    if (digit[r] >= 0 && 31 - __clz(same) == lane)
      mine[digit[r]] += __popc(same);
    __syncwarp();
  }
  bar_sync(kBarCompute, kCompute);
  // per digit: each warp's base, then the digits' starts
  int total = 0;
  if (tid < kDigits) {
    for (int w = 0; w < kComputeWarps; ++w) {
      const int c = counters[w * kDigits + tid];
      counters[w * kDigits + tid] = total;
      total += c;
    }
  }
  int all;
  const int start = group_scan<kCompute>(total, scratch, all, kBarCompute);
  if (tid < kDigits)
    for (int w = 0; w < kComputeWarps; ++w)
      counters[w * kDigits + tid] += start;
  bar_sync(kBarCompute, kCompute);
#pragma unroll
  for (int r = 0; r < kSortRounds; ++r) {
    if (r >= rounds) break;
    const int e = e0 + r * 32 + lane;
    if (digit[r] >= 0) {
      const int at = mine[digit[r]] + rank[r];
      kout[at] = kin[e];
      bout[at] = bin[e];
    }
  }
  bar_sync(kBarCompute, kCompute);
}

// Without a partition (N <= kScanMax): the compute warps stage tile t's
// ids in shared memory (coalesced), test kPerThread consecutive ones a
// thread and, if this block's positions among them fit after the `count`
// the chunk holds, append them in position order (a prefix over the
// group; not when `keys` is null) and mark their rows in `mark` (when
// not null). `bags` gets the positions; bags_of_positions turns them
// into bags. Returns how many there are, or -1 when they do not fit.
__device__ int scan_tile(const Args& a, int t, int count, int chunk,
                         uint32_t* keys, int32_t* bags, uint32_t* mark,
                         int32_t* staged, int* scratch) {
  const int tid = threadIdx.x;
  const int n_valid =
      a.n_bags > 0 ? max(0, min(a.n, __ldg(a.offsets + a.n_bags))) : 0;
  const int t0 = t * kTile;
  const int len = max(0, min(n_valid - t0, kTile));
  for (int i = tid; i < len; i += kCompute) staged[i] = __ldg(a.ids + t0 + i);
  bar_sync(kBarCompute, kCompute);
  const int k0 = tid * kPerThread;
  int local[kPerThread];
  unsigned mask = 0u;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    local[k] = k0 + k < len ? local_row(a, staged[k0 + k]) : -1;
    if (local[k] >= 0) mask |= 1u << k;
  }
  int total;
  int idx = group_scan<kCompute>(__popc(mask), scratch, total, kBarCompute);
  if (count + total > chunk) return -1;  // the same for every thread
  idx += count;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    if (local[k] < 0) continue;
    if (keys) {
      keys[idx] = static_cast<uint32_t>(local[k]);
      bags[idx] = t0 + k0 + k;
    }
    if (mark) atomicOr(mark + (local[k] >> 5), 1u << (local[k] & 31));
    ++idx;
  }
  bar_sync(kBarCompute, kCompute);
  return total;
}

// bags[0 .. count) hold ascending positions; each thread turns a
// contiguous run of them into bags, walking along offsets from its
// previous one
__device__ void bags_of_positions(const Args& a, int32_t* bags, int count) {
  const int tid = threadIdx.x;
  const int per = (count + kCompute - 1) / kCompute;
  const int e1 = min(count, (tid + 1) * per);
  int seg = 0;
  for (int e = tid * per; e < e1; ++e) {
    seg = count_le(a.offsets + 1, a.n_bags, bags[e], seg);
    bags[e] = min(seg, a.n_bags - 1);
  }
  bar_sync(kBarCompute, kCompute);
}

// Gathers this block's entries of whole tiles from `next_tile` on, in
// position order, while they fit after `count` in a chunk of `chunk`:
// appends them to keys (local rows) and bags (null keys: appends
// nothing) and marks their rows in `mark` (when not null). Advances
// next_tile; returns the new count.
__device__ int gather(const Args& a, int& next_tile, int count, int chunk,
                      uint32_t* keys, int32_t* bags, uint32_t* mark,
                      int32_t* staged, int* got_at, int* got_from,
                      int* scratch) {
  const int tid = threadIdx.x;
  const int blocks = 1 << a.block_log;
  while (!a.partition && next_tile < a.n_tiles) {
    const int got = scan_tile(a, next_tile, count, chunk, keys, bags, mark,
                              staged, scratch);
    if (got < 0) return count;
    count += got;
    ++next_tile;
  }
  while (a.partition && next_tile < a.n_tiles) {
    const int t = next_tile + tid;
    const int64_t at = static_cast<int64_t>(t) * blocks + blockIdx.x;
    const int cnt = t < a.n_tiles ? a.tile_count[at] : 0;
    int total;
    const int pre = group_scan<kCompute>(cnt, scratch, total, kBarCompute);
    // whole tiles while the chunk holds them, at most kGatherPer entries
    // a thread this round
    const int fits = t < a.n_tiles && count + pre + cnt <= chunk &&
                     pre + cnt <= kGatherPer * kCompute;
    int n_fit;
    group_scan<kCompute>(fits, scratch, n_fit, kBarCompute);
    if (n_fit == 0) break;  // the chunk is full
    if (fits) {
      got_at[tid] = pre;
      got_from[tid] = t * kTile + a.tile_start[at];
      if (tid == n_fit - 1) scratch[kComputeWarps] = pre + cnt;
    }
    bar_sync(kBarCompute, kCompute);
    const int got = scratch[kComputeWarps];
    // every load of the thread in flight before any is used
    int from[kGatherPer];
#pragma unroll
    for (int i = 0; i < kGatherPer; ++i) {
      const int e = tid + i * kCompute;
      int lo = 0, hi = n_fit - 1;  // the last gathered tile at or below e
      while (e < got && lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (got_at[mid] <= e)
          lo = mid;
        else
          hi = mid - 1;
      }
      from[i] = e < got ? got_from[lo] + e - got_at[lo] : -1;
    }
    int2 entry[kGatherPer];
#pragma unroll
    for (int i = 0; i < kGatherPer; ++i)
      if (from[i] >= 0) entry[i] = a.entries[from[i]];
#pragma unroll
    for (int i = 0; i < kGatherPer; ++i) {
      if (from[i] < 0) continue;
      const int e = tid + i * kCompute;
      if (keys) {
        keys[count + e] = static_cast<uint32_t>(entry[i].x);
        bags[count + e] = entry[i].y;
      }
      if (mark) atomicOr(mark + (entry[i].x >> 5), 1u << (entry[i].x & 31));
    }
    count += got;
    next_tile += n_fit;
    bar_sync(kBarCompute, kCompute);
  }
  return count;
}

__global__ void __launch_bounds__(kThreads, 1)
    sls_grad_table_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = 1 << a.chunk_log;
  const int tile_words = a.tile * a.dim;
  const int bitmap_words = (a.rows_per_block + 31) >> 5;
  float* tiles = smem;                            // 16-byte aligned
  float* carry = tiles + kStages * tile_words;    // and so is this
  uint32_t* keys = reinterpret_cast<uint32_t*>(carry + 2 * a.dim);
  int32_t* bags = reinterpret_cast<int32_t*>(keys + chunk);
  uint32_t* keys2 = reinterpret_cast<uint32_t*>(bags + chunk);
  int32_t* bags2 = reinterpret_cast<int32_t*>(keys2 + chunk);
  int* counters = bags2 + chunk;
  // rows any position touches (the sweep skips them), and rows a chunk
  // has written (a later chunk goes on from what it wrote)
  uint32_t* touched =
      reinterpret_cast<uint32_t*>(counters + kComputeWarps * kDigits);
  uint32_t* written = touched + bitmap_words;
  int32_t* got_at = reinterpret_cast<int32_t*>(written + bitmap_words);
  int32_t* got_from = got_at + kCompute;
  int32_t* scratch = got_from + kCompute;
  int* claim = scratch + kComputeWarps + 1;  // the sweep's next granule

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (warp >= kComputeWarps) {
    bar_sync(kBarCollected, kThreads);
    sweep(a, touched, claim);
    return;
  }

  for (int i = tid; i < 2 * bitmap_words; i += kCompute) touched[i] = 0u;
  if (tid == 0) *claim = 0;
  bar_sync(kBarCompute, kCompute);
  // the sort's passes: digits of the local row, low first
  int passes = 0;
  while (passes * kDigitBits < 31 &&
         ((a.rows_per_block - 1) >> (passes * kDigitBits)) > 0)
    ++passes;
  // lanes a run takes: its row's 16-byte (or 4-byte) parts, up to 32
  const int unit = a.vec ? a.dim >> 2 : a.dim;
  int lanes = 1;
  while (lanes < 32 && lanes < unit) lanes <<= 1;
  const int group = warp * (32 / lanes) + lane / lanes;
  const int sub = lane % lanes;
  int next_tile = 0;  // the first partition tile of the next chunk
  for (int c = 0;; ++c) {
    // 1. gather whole tiles' entries, in position order, up to a chunk;
    // the first chunk marks every row the block's positions touch (those
    // of later chunks too), and the sweep starts
    int32_t* staged = reinterpret_cast<int32_t*>(keys2);
    const int count = gather(a, next_tile, 0, chunk, keys, bags,
                             c == 0 ? touched : nullptr, staged, got_at,
                             got_from, scratch);
    if (c == 0) {
      int rest = next_tile;
      if (rest < a.n_tiles)
        gather(a, rest, 0, 0x7fffffff, nullptr, nullptr, touched, staged,
               got_at, got_from, scratch);
      __threadfence_block();
      bar_arrive(kBarCollected, kThreads);
    } else if (count == 0) {
      break;
    }
    if (!a.partition) bags_of_positions(a, bags, count);

    // 2. sort the entries by local row, stably: position order within
    // a row is kept
    uint32_t* k_in = keys;
    int32_t* b_in = bags;
    uint32_t* k_out = keys2;
    int32_t* b_out = bags2;
    for (int pass = 0; pass < passes; ++pass) {
      sort_pass(k_in, b_in, k_out, b_out, count, pass * kDigitBits,
                counters, scratch);
      uint32_t* kt = k_in;
      k_in = k_out;
      k_out = kt;
      int32_t* bt = b_in;
      b_in = b_out;
      b_out = bt;
    }
    const uint32_t* key = k_in;
    const int32_t* bag_of = b_in;
    // the chunk's runs of equal rows: where each starts, and the run that
    // holds each g tile's first entry (in the sort's spare buffers)
    int* run_start = reinterpret_cast<int*>(k_out);
    int* tile_run = b_out;
    int n_runs;
    {
      const int per = (count + kCompute - 1) / kCompute;
      const int e0 = min(count, tid * per), e1 = min(count, e0 + per);
      int mine = 0;
      for (int e = e0; e < e1; ++e) mine += e == 0 || key[e] != key[e - 1];
      int r = group_scan<kCompute>(mine, scratch, n_runs, kBarCompute);
      for (int e = e0; e < e1; ++e) {
        const bool first = e == 0 || key[e] != key[e - 1];
        if (e % a.tile == 0) tile_run[e / a.tile] = first ? r : r - 1;
        if (first) run_start[r++] = e;
      }
      bar_sync(kBarCompute, kCompute);
    }

    // 3. stream the sorted entries' g rows through the tile ring; groups
    // of lanes sum each run in order and write its row once
    const int n_tiles = (count + a.tile - 1) / a.tile;
    auto issue = [&](int k) {
      if (k < n_tiles) {
        const int t0 = k * a.tile;
        const int rows = min(count - t0, a.tile);
        float* dst = tiles + (k % kStages) * tile_words;
        for (int i = tid; i < rows * unit; i += kCompute) {
          const int e = div_unit(a, i);
          const int part = i - e * unit;
          const int64_t bag = bag_of[t0 + e];
          if (a.vec)
            cp_async16(dst + e * a.dim + 4 * part,
                       a.g + bag * a.dim + 4 * part);
          else
            cp_async4(dst + e * a.dim + part, a.g + bag * a.dim + part);
        }
      }
      cp_async_commit();  // empty past the last tile, so wait_group counts
    };
    for (int k = 0; k < kStages - 1; ++k) issue(k);
    for (int k = 0; k < n_tiles; ++k) {
      issue(k + kStages - 1);
      cp_async_wait_oldest();
      bar_sync(kBarCompute, kCompute);
      const int t0 = k * a.tile;
      const int t1 = min(count, t0 + a.tile);
      // the runs that overlap [t0, t1)
      const int r0 = tile_run[k];
      const int r1 = k + 1 < n_tiles ? tile_run[k + 1] -
                                           (run_start[tile_run[k + 1]] == t1)
                                     : n_runs - 1;
      const float* tl = tiles + (k % kStages) * tile_words;
      const float* c_in = carry + ((k + 1) & 1) * a.dim;
      float* c_out = carry + (k & 1) * a.dim;
      for (int s = r0 + group; s <= r1; s += kCompute / lanes) {
        // the run's part in this tile, where its sum starts (carried from
        // the last tile, read back from what an earlier chunk wrote, or
        // zero) and where it goes (on to the next tile, or its row)
        const int j0 = run_start[s];
        const int j1 = s + 1 < n_runs ? run_start[s + 1] : count;
        const int q0 = max(j0, t0), q1 = min(j1, t1);
        const uint32_t local = key[q0];
        float* row = a.out + global_row(a, static_cast<int>(local)) * a.dim;
        const float* from =
            j0 < t0 ? c_in
            : c > 0 && ((written[local >> 5] >> (local & 31)) & 1u) ? row
                                                                     : nullptr;
        float* to = j1 > t1 ? c_out : row;
        if (a.vec) {
          for (int f = sub; f < unit; f += lanes) {
            float4 acc = from ? reinterpret_cast<const float4*>(from)[f]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
            const float4* src =
                reinterpret_cast<const float4*>(tl + (q0 - t0) * a.dim) + f;
#pragma unroll 8
            for (int q = q0; q < q1; ++q, src += unit) {
              const float4 v = *src;
              acc.x += v.x;
              acc.y += v.y;
              acc.z += v.z;
              acc.w += v.w;
            }
            reinterpret_cast<float4*>(to)[f] = acc;
          }
        } else {
          for (int d = sub; d < a.dim; d += lanes) {
            float acc = from ? from[d] : 0.f;
            const float* src = tl + (q0 - t0) * a.dim + d;
#pragma unroll 8
            for (int q = q0; q < q1; ++q, src += a.dim) acc += *src;
            to[d] = acc;
          }
        }
      }
      bar_sync(kBarCompute, kCompute);
    }
    if (next_tile >= a.n_tiles) break;
    // the rows this chunk wrote, for the next chunk to go on from
    for (int s = tid; s < n_runs; s += kCompute) {
      const uint32_t local = key[run_start[s]];
      atomicOr(written + (local >> 5), 1u << (local & 31));
    }
    bar_sync(kBarCompute, kCompute);
  }
  sweep(a, touched, claim);  // help with what is left of it
}

// raise a kernel's dynamic shared memory limit, once a device
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<bool>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

std::atomic<bool> main_smem_done[kMaxDevices];
std::atomic<bool> partition_smem_done[kMaxDevices];

int log2_exact(int x) {
  if (x < 1 || (x & (x - 1))) return -1;
  int l = 0;
  while ((1 << l) < x) ++l;
  return l;
}

}  // namespace

// The plan (blocks, granule, chunk, tile, rows_per_block) comes from
// kernels/embedding_gather.py:grad_plan, and smem_bytes is its count of
// the main kernel's shared memory; a plan these kernels cannot run, or a
// count that disagrees with their own, is refused with
// cudaErrorInvalidValue. `work` holds 2 n + 2 ceil(n / 4096) blocks
// ints: the partition's entries, tile counts and tile starts. Two
// launches when n > 0 (the partition, then the main kernel), else one.
extern "C" int sls_grad_table_f32(const float* g, const int32_t* ids,
                                  const int32_t* offsets, float* out,
                                  int32_t* work, int n, int n_bags,
                                  int n_rows, int dim, int skip_row,
                                  int blocks, int granule, int chunk,
                                  int tile, int rows_per_block,
                                  int smem_bytes, int partition,
                                  cudaStream_t stream) {
  const int block_log = log2_exact(blocks);
  const int granule_log = log2_exact(granule);
  const int chunk_log = log2_exact(chunk);
  if (n < 0 || n > kMaxPositions || n_bags < 0 || n_rows < 1 || dim < 1 ||
      block_log < 0 || blocks > kMaxBlocks || granule_log < 0 ||
      chunk_log < 5 || chunk_log > kMaxChunkLog || chunk < min(n, kTile) ||
      (!partition && n > kScanMax) ||
      tile < 1 || tile > kCompute || rows_per_block < granule ||
      rows_per_block % granule || rows_per_block > kMaxRowsPerBlock ||
      static_cast<int64_t>(blocks) * rows_per_block < n_rows ||
      static_cast<int64_t>(tile) * dim > 8192 ||
      static_cast<int64_t>(granule) * dim * dim >= (1LL << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bytes = 4 * smem_words(dim, chunk, tile, rows_per_block);
  const int64_t pbytes = 4 * partition_smem_words(blocks);
  if (bytes != smem_bytes || bytes > kMaxSmem || pbytes > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(sls_grad_table_kernel, main_smem_done);
  if (err == cudaSuccess)
    err = allow_smem(sls_grad_partition_kernel, partition_smem_done);
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.g = g;
  a.ids = ids;
  a.offsets = offsets;
  a.out = out;
  a.n_tiles = static_cast<int>((static_cast<int64_t>(n) + kTile - 1) / kTile);
  a.partition = partition != 0;
  a.entries = reinterpret_cast<int2*>(work);
  a.tile_count = work + 2LL * n;
  a.tile_start = a.tile_count + static_cast<int64_t>(a.n_tiles) * blocks;
  a.n = n;
  a.n_bags = n_bags;
  a.n_rows = n_rows;
  a.dim = dim;
  a.skip_row = skip_row;
  a.block_log = block_log;
  a.granule_log = granule_log;
  a.chunk_log = chunk_log;
  a.tile = tile;
  a.rows_per_block = rows_per_block;
  a.vec = dim % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const uint64_t unit = a.vec ? dim / 4 : dim;
  a.magic = ((1ULL << 32) + unit - 1) / unit;
  if (a.partition && a.n_tiles > 0) {
    sls_grad_partition_kernel<<<a.n_tiles, kThreads, pbytes, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  sls_grad_table_kernel<<<blocks, kThreads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
