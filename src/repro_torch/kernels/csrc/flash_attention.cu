// Causal / windowed online-softmax attention, forward only, bf16 in and
// out with fp32 scores and state: out(B, S, H, d) from q(B, S, H, d) and
// k, v(B, S, KH, d), query head h reading kv head h / (H / KH).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:77
// flash_attention (body _flash_kernel, :31) and its GQA wrapper
// flash_attention_gqa (:113), which repeats the kv heads in HBM first;
// here each block names its kv head as a TMA coordinate instead, so
// nothing is repeated.
//
// Bound: operations. Causal attention at S = 4096, d = 64 does ~350
// flops per byte of q, k, v and out, above the card's ~295 bf16 flops
// per byte, so the tensor cores are the limit. The design is the usual
// Hopper attention shape:
//
// * Warp specialisation. A block owns one (batch x head, q tile) and has
//   C consumer warpgroups of 64 query rows each and one producer
//   warpgroup, in which one thread issues every TMA copy. C is fixed per
//   depth: 1 (a 64-row q tile, two blocks an SM, so that one block's
//   softmax overlaps the other's products) at depths up to 80, 2 (a
//   128-row tile, one block an SM) at 128; on the H100 each was the
//   faster of the two at its depths. Depth 256 takes 1 with one block an
//   SM (see 8.). setmaxnreg hands the
//   producer's registers to the consumers at run time, but ptxas
//   allocates the whole kernel within its launch bound (168 registers a
//   thread for C = 2, 128 for C = 1), so the consumer loop is written to
//   fit those with no spills: one score tile, its P fragments and O.
//   Overlapping tile i's QK^T and softmax with tile i - 1's PV (a second
//   live score tile) spilled at 128 and was slower on the H100.
// * TMA and a ring. Q is copied once; K and V tiles of 128 keys (64 at
//   depth 256) go into a ring of two stages, K and V behind separate
//   "full" mbarriers (QK^T starts before V has landed) and one "empty"
//   mbarrier a stage that every consumer warp arrives on when its
//   products have read the stage. The tensor maps describe q, k, v in
//   their own (B, S, H | KH, d) layout, 4-d, with the kv head as a
//   coordinate.
// * Both products on wgmma, fp32 accumulation. S = Q K^T is
//   m64n128k16 (m64n64k16 at depth 256) with Q and K from swizzled
//   shared memory, both K-major as stored. O += P V takes P from
//   registers (the S accumulators, rounded to bf16, are the A
//   fragments) and V from shared memory as an
//   MN-major B operand (the transpose flag of 16-bit wgmma): nothing is
//   transposed in device memory.
// * Softmax in the exp2 domain with d^-0.5 log2(e) folded into one
//   multiply. Only the tiles that cross the diagonal, the window edge or
//   S take the mask arithmetic; the others skip it. The row sum is kept
//   per thread and reduced across the quad once, at the end.
//
// The reference's numerics, kept: fp32 scores from bf16 operands;
// masked entries -1e30, never -inf (a row whose first walked tile is
// wholly masked, as the bottom rows of a 128-row tile under a window of
// 512 are, takes m = -1e30 and exp2(0) terms that the next tile's corr =
// 0 wipes out); P rounded to bf16 before PV while l adds the fp32 P;
// out = acc / max(l, 1e-30), rounded to bf16. kv tiles wholly outside
// the causal and window band of the whole q tile are skipped: the
// reference issues them, but a fully masked tile only adds exp(0) terms
// that the first valid tile wipes through corr = 0, and every row has a
// valid key (its own), so the function is the same. No split-KV and no
// atomics: every output element is written once by one thread, so runs
// are deterministic.
//
// How the places of trouble were settled:
// 1. TMA's rules: the global address 16-byte aligned and every stride a
//    multiple of 16 bytes. Head dims 16, 64, 80 and 128 (head strides of
//    32, 128, 160 and 256 bytes) meet them for any head count; hd 20 (40
//    bytes) does not, so the wrapper pads q, k and v to 32 with one copy
//    each and passes the scale of 20; this kernel runs the depth-32
//    instantiation and stores the first 20 columns only (d_out). Head
//    dim 112 (the MoE decoders) takes the same route to depth 128 (see
//    7.): the zero columns add exact zeros to every score and to O's
//    last 16 columns, which are not stored. The wrapper raises on an
//    address off the 16-byte rule.
// 2. Swizzle and box widths: the head dim is cut into panels of 64, 32
//    or 16 columns, each a TMA box whose rows are exactly its swizzle
//    width (128, 64 or 32 bytes): 16 -> [16], 32 -> [32], 64 -> [64], 80
//    -> [64, 16], 128 -> [64, 64]. QK^T walks the panels' k-steps of 16
//    (depth 80 exactly, no padding to 96 or 128), PV issues one wgmma a
//    panel (N = 64 and 16 at hd 80). Every wgmma descriptor takes its
//    panel's swizzle mode, 8-row group stride (8 x the row bytes) and a
//    start address inside a 1024-byte aligned atom: a K-major k-step
//    moves the start by 32 bytes, an MN-major one by 16 rows.
// 3. Keys past S: TMA zero-fills them, so their scores come out 0; the
//    kpos < S mask stays. Rows of q past S are not stored.
// 4. Tensor maps: cuTensorMapEncodeTiled comes from
//    cudaGetDriverEntryPoint(ByVersion), so nothing links -lcuda; the
//    maps travel as one __grid_constant__ parameter; the C entry
//    returns the encode error (offset by kEncodeError) or
//    cudaGetLastError(). The dynamic shared memory (161 KB at hd 128,
//    165 KB at 256) is raised with cudaFuncSetAttribute once per
//    instantiation and device, so a launch's host work is the maps and
//    the launch.
// 5. Build time: the PTX is written inline (wgmma, TMA, mbarrier,
//    setmaxnreg), no CUTLASS or CuTe headers.
// 6. Hangs: an mbarrier wait that has not completed after 30 seconds
//    traps, so a wrong phase parity fails instead of hanging the card.
//    A trap is a sticky error: it ends the whole CUDA context of the
//    process, not only this launch, so the bound is far above any wait
//    of a correct run (a tile's wait is microseconds).
// 7. Head dims 16, 20 (as 32), 64, 80, 112 (as 128), 128 and 256 are
//    instantiated. 112 as itself would take three panels, [64, 32, 16],
//    of two widths after the first, so it runs padded at 128: 14% more
//    MMA work and the wrapper's three copies.
// 8. Depth 256 (recurrentgemma-9b) is four panels of 64, and two limits
//    shape it. Shared memory: with 128-key tiles two stages of K and V
//    alone would take 256 KB of the block's 227 KB, so its kv tile is 64
//    keys (kBK is a function of the depth): Q 32 KB and two stages of K
//    and V at 32 KB each, 160 KB with the mbarriers. Registers: O is 128
//    fp32 registers a thread, the 64 x 64 score tile 32 and P's bf16
//    fragments 16, past what C = 2 (168) or two blocks an SM (128)
//    leave; so C = 1 and one block of 256 threads an SM, whose launch
//    bound lets ptxas give every thread up to 255 registers. There is
//    nothing for setmaxnreg to hand over at that bound, and the depth
//    runs without it. QK^T is 16 wgmma k-steps (m64n64k16) over the four
//    panels, PV one m64n64k16 a panel for each 16-key step. kt_lo and
//    kt_hi count 64-key tiles, so at S = 4096 with a window of 2048 a
//    64-row q tile walks at most 33 of the 64.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>

namespace {

constexpr int kStages = 2;         // K/V ring depth
constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr uint64_t kHangNs = 30000000000ull;  // see the header, 6.
constexpr int kMaxDevices = 64;
// the C entry returns kEncodeError + CUresult when a tensor map fails
constexpr int kEncodeError = 20000;

// keys per kv tile (see the header, 8.)
template <int HD>
constexpr int kKeys = HD == 256 ? 64 : 128;

// The head dim as panels (see the header, 2. and 8.): panel 0 of kW0
// columns, then kPanels - 1 panels of kW1 columns each
template <int HD>
struct Layout {
  static constexpr int kW0 = HD < 64 ? HD : 64;
  static constexpr int kW1 = HD == 256 ? 64 : HD - kW0;
  static constexpr int kPanels = HD == 256 ? 4 : (kW1 > 0 ? 2 : 1);
  static_assert(kW0 == 16 || kW0 == 32 || kW0 == 64, "panel 0");
  static_assert(kW1 == 0 || kW1 == 16 || kW1 == 64, "panels 1..");
  static_assert(kW0 + (kPanels - 1) * kW1 == HD, "panels cover the depth");
};

// shared memory of one block, in bytes from a 1024-aligned base: Q, then
// per stage K and V (each panel by panel), then the mbarriers
template <int HD, int C>
struct Smem {
  static constexpr int kBK = kKeys<HD>;
  static constexpr int kBQ = 64 * C;
  static constexpr int kQBytes = kBQ * HD * 2;
  static constexpr int kTileBytes = kBK * HD * 2;
  static constexpr int kQ1 = kBQ * Layout<HD>::kW0 * 2;  // panel 1 of Q
  static constexpr int kT1 = kBK * Layout<HD>::kW0 * 2;  // of a K/V tile
  // panel p >= 1 starts at kQ1 + (p - 1) kQP (of Q), kT1 + (p - 1) kTP
  // (of a K/V tile)
  static constexpr int kQP = kBQ * Layout<HD>::kW1 * 2;
  static constexpr int kTP = kBK * Layout<HD>::kW1 * 2;
  static constexpr int kBars = kQBytes + kStages * 2 * kTileBytes;
  // q_full, k_full[stages], v_full[stages], empty[stages]
  static constexpr int kBytes = kBars + 8 * (1 + 3 * kStages) + 1024;
  __device__ static constexpr int k_off(int st) {
    return kQBytes + st * 2 * kTileBytes;
  }
  __device__ static constexpr int v_off(int st) {
    return k_off(st) + kTileBytes;
  }
};

constexpr int kMaxPanels = 4;
struct Maps {
  CUtensorMap q[kMaxPanels], k[kMaxPanels], v[kMaxPanels];  // one a panel
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint64_t globaltimer() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// wait for the phase of parity `parity` to complete; trap (ending the
// process's CUDA context) rather than hang the card when it never does
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try(bar, parity)) return;
  const uint64_t t0 = globaltimer();
  while (!mbar_try(bar, parity)) {
    if (globaltimer() - t0 > kHangNs) __trap();
  }
}

// one TMA box of a 4-d map (d, heads, S, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a panel `w` columns wide, stored as
// rows of 2w bytes in TMA's matching swizzle (128, 64 or 32 bytes): the
// 8-row group stride is 16w bytes along the rows (both byte offsets carry
// it; the other is unused, since no operand spans two swizzle atoms
// across a row)
template <int W>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  constexpr uint64_t kGroup = (16 * W) >> 4;
  constexpr uint64_t kMode = W == 64 ? 1 : (W == 32 ? 2 : 3);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kGroup << 16) |
         (kGroup << 32) | (kMode << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous region of a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d(64 x 128) (+)= a(64 x 16, smem) b(16 x 128, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d(64 x 64) (+)= a(64 x 16, smem) b(16 x 64, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S (+)= Q K^T over one k-step: N keys (the kv tile) a wgmma
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 128) {
    wgmma_ss_n128(d, da, db, accumulate);
  } else {
    wgmma_ss_n64(d, da, db, accumulate);
  }
}

// d(64 x 64) += a(64 x 16, registers) b(16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d(64 x 32) += a(64 x 16, registers) b(16 x 32, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d(64 x 16) += a(64 x 16, registers) b(16 x 16, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 64) {
    wgmma_rs_n64(d, a, db);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, db);
  } else {
    wgmma_rs_n16(d, a, db);
  }
}

// consumer warpgroups of 64 query rows a block, and blocks an SM, per
// depth (the header)
template <int HD>
constexpr int kConsumers = HD == 128 ? 2 : 1;
template <int HD>
constexpr int kMinBlocks = HD <= 80 ? 2 : 1;

// HD: the depth of q, k, v (16, 32, 64, 80, 128 or 256); C: consumer
// warpgroups, 64 query rows each
template <int HD, int C>
__global__ void __launch_bounds__((C + 1) * 128, kMinBlocks<HD>)
flash_attention_kernel(const __grid_constant__ Maps maps,
                       __nv_bfloat16* __restrict__ out, int s_len,
                       int n_heads, int n_kv_heads, int d_out,
                       float scale_log2, int causal, int window) {
  using L = Layout<HD>;
  using M = Smem<HD, C>;
  constexpr int W0 = L::kW0, W1 = L::kW1, NP = L::kPanels;
  constexpr int kBQ = M::kBQ, kBK = M::kBK;
  static_assert(M::kQ1 % 1024 == 0 && M::kT1 % 1024 == 0 &&
                    M::kQP % 1024 == 0 && M::kTP % 1024 == 0 &&
                    M::kQBytes % 1024 == 0 && M::kTileBytes % 1024 == 0,
                "every panel starts on a 1024-byte swizzle atom");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + M::kBars;
  auto k_full = [&](int st) { return base + M::kBars + 8 * (1 + st); };
  auto v_full = [&](int st) {
    return base + M::kBars + 8 * (1 + kStages + st);
  };
  auto empty = [&](int st) {
    return base + M::kBars + 8 * (1 + 2 * kStages + st);
  };

  const int bh = blockIdx.x;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int kvh = h / (n_heads / n_kv_heads);
  // grid.y walks the q tiles from the last: the heaviest causal tiles of
  // every head are dispatched first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  // the kv tiles that hold a key inside the band of some row of the tile
  const int q_last = min(q0 + kBQ - 1, s_len - 1);
  const int n_kt = (s_len + kBK - 1) / kBK;
  const int kt_hi = causal ? min(n_kt - 1, q_last / kBK) : n_kt - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(empty(st), 4 * C);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C * 128) {
    // ---------------------------------------------------------- producer
    if constexpr (kMinBlocks<HD> == 2 || C == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == C * 128) {
      mbar_expect_tx(q_full, M::kQBytes);
      tma_load(base, &maps.q[0], q_full, 0, h, q0, b);
#pragma unroll
      for (int p = 1; p < NP; ++p)
        tma_load(base + M::kQ1 + (p - 1) * M::kQP, &maps.q[p], q_full,
                 W0 + (p - 1) * W1, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        const int k0 = (kt_lo + i) * kBK;
        const uint32_t kd = base + M::k_off(st), vd = base + M::v_off(st);
        mbar_expect_tx(k_full(st), M::kTileBytes);
        tma_load(kd, &maps.k[0], k_full(st), 0, kvh, k0, b);
#pragma unroll
        for (int p = 1; p < NP; ++p)
          tma_load(kd + M::kT1 + (p - 1) * M::kTP, &maps.k[p], k_full(st),
                   W0 + (p - 1) * W1, kvh, k0, b);
        mbar_expect_tx(v_full(st), M::kTileBytes);
        tma_load(vd, &maps.v[0], v_full(st), 0, kvh, k0, b);
#pragma unroll
        for (int p = 1; p < NP; ++p)
          tma_load(vd + M::kT1 + (p - 1) * M::kTP, &maps.v[p], v_full(st),
                   W0 + (p - 1) * W1, kvh, k0, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    } else if constexpr (kMinBlocks<HD> == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    }
    const int wg = threadIdx.x / 128;
    const int warp = (threadIdx.x % 128) / 32;
    const int lane = threadIdx.x % 32;
    const int t = lane % 4;        // column pair of the accumulator layout
    const int row_lo = q0 + wg * 64;
    // this thread's two rows: r0 = row_lo + warp*16 + lane/4, r1 = r0 + 8
    const int r0 = row_lo + warp * 16 + lane / 4;
    const int r1 = r0 + 8;
    // Q rows of this warpgroup, per panel (panel p >= 1 at qa1 + (p - 1)
    // kQP)
    const uint32_t qa0 = base + wg * 64 * (2 * W0);
    const uint32_t qa1 = base + M::kQ1 + wg * 64 * (2 * W1);

    // O's panel 0, and panels 1 .. NP - 1
    constexpr int kO1 = W1 > 0 ? W1 / 2 : 1;
    float o0[W0 / 2];
    float o1[NP > 1 ? NP - 1 : 1][kO1];
#pragma unroll
    for (int i = 0; i < W0 / 2; ++i) o0[i] = 0.f;
#pragma unroll
    for (int p = 0; p < (NP > 1 ? NP - 1 : 1); ++p) {
#pragma unroll
      for (int i = 0; i < kO1; ++i) o1[p][i] = 0.f;
    }
    float m_row[2] = {kNegInf, kNegInf};
    float l_part[2] = {0.f, 0.f};  // this thread's share of the row sum

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = (kt_lo + i) * kBK;
      const uint32_t kb = base + M::k_off(st), vb = base + M::v_off(st);

      // s = q k^T (raw, fp32): HD / 16 k-steps over the panels
      float s[kBK / 2];
      mbar_wait(k_full(st), parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W0 / 16; ++kk)
        wgmma_ss<kBK>(s, make_desc<W0>(qa0 + 32 * kk),
                      make_desc<W0>(kb + 32 * kk), kk);
#pragma unroll
      for (int p = 1; p < NP; ++p) {
#pragma unroll
        for (int kk = 0; kk < W1 / 16; ++kk)
          wgmma_ss<kBK>(s, make_desc<W1>(qa1 + (p - 1) * M::kQP + 32 * kk),
                        make_desc<W1>(kb + M::kT1 + (p - 1) * M::kTP +
                                      32 * kk),
                        1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale (into the exp2 domain), mask where the tile needs it, and
      // the rows' max; s[4j + e] is row (e < 2 ? r0 : r1), key k0 + 8j +
      // 2t + (e & 1)
      const bool masked = k0 + kBK > s_len ||
                          (causal && k0 + kBK - 1 > row_lo) ||
                          (window > 0 && k0 <= row_lo + 63 - window);
      float mx[2];
      if (masked) {
        mx[0] = mx[1] = kNegInf;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = e < 2 ? r0 : r1;
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            bool keep = kpos < s_len;
            if (causal) keep = keep && kpos <= qpos;
            if (window > 0) keep = keep && kpos > qpos - window;
            const float x = keep ? s[4 * j + e] * scale_log2 : kNegInf;
            s[4 * j + e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
      } else {
        mx[0] = mx[1] = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
        }
        // scale_log2 > 0, so the max of the scaled scores is the scaled max
        mx[0] *= scale_log2;
        mx[1] *= scale_log2;
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_row[r], mx[r]);
        corr[r] = ex2(m_row[r] - m_new);
        m_row[r] = m_new;
      }
      // p = exp2(s - m_new): fp32 into the row sum, bf16 into PV's A
      // fragments (keys 16kk .. 16kk + 15 are n8 chunks 2kk and 2kk + 1)
      float sum[2] = {0.f, 0.f};
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float m = m_row[e >> 1];
          const float p = masked ? ex2(s[4 * j + e] - m)
                                 : ex2(fmaf(s[4 * j + e], scale_log2, -m));
          s[4 * j + e] = p;
          sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_part[r] = l_part[r] * corr[r] + sum[r];
#pragma unroll
      for (int j = 0; j < W0 / 8; ++j) {
        o0[4 * j + 0] *= corr[0];
        o0[4 * j + 1] *= corr[0];
        o0[4 * j + 2] *= corr[1];
        o0[4 * j + 3] *= corr[1];
      }
#pragma unroll
      for (int p = 0; p < NP - 1; ++p) {
#pragma unroll
        for (int j = 0; j < W1 / 8; ++j) {
          o1[p][4 * j + 0] *= corr[0];
          o1[p][4 * j + 1] *= corr[0];
          o1[p][4 * j + 2] *= corr[1];
          o1[p][4 * j + 3] *= corr[1];
        }
      }

      // o += bf16(p) v: one wgmma a panel and k-step of 16 keys
      mbar_wait(v_full(st), parity);
      fence_regs(o0);
#pragma unroll
      for (int p = 0; p < (NP > 1 ? NP - 1 : 1); ++p) fence_regs(o1[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_rs<W0>(o0, pa[kk], make_desc<W0>(vb + kk * 16 * (2 * W0)));
        if constexpr (NP > 1) {
#pragma unroll
          for (int p = 0; p < NP - 1; ++p)
            wgmma_rs<W1>(o1[p], pa[kk],
                         make_desc<W1>(vb + M::kT1 + p * M::kTP +
                                       kk * 16 * (2 * W1)));
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o0);
#pragma unroll
      for (int p = 0; p < (NP > 1 ? NP - 1 : 1); ++p) fence_regs(o1[p]);
      // this warp's products have read the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(st));
    }

    // out = acc / max(l, 1e-30), rounded to bf16; rows past S not stored
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_part[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      den[r] = fmaxf(l, 1e-30f);
    }
    const int64_t row = static_cast<int64_t>(n_heads) * d_out;
    __nv_bfloat16* ob = out + static_cast<int64_t>(b) * s_len * row +
                        static_cast<int64_t>(h) * d_out;
    auto store = [&](int col, float a0, float a1, float a2, float a3) {
      if (col >= d_out) return;
      if (r0 < s_len)
        *reinterpret_cast<uint32_t*>(ob + r0 * row + col) =
            pack_bf16(a0 / den[0], a1 / den[0]);
      if (r1 < s_len)
        *reinterpret_cast<uint32_t*>(ob + r1 * row + col) =
            pack_bf16(a2 / den[1], a3 / den[1]);
    };
#pragma unroll
    for (int j = 0; j < W0 / 8; ++j)
      store(8 * j + 2 * t, o0[4 * j], o0[4 * j + 1], o0[4 * j + 2],
            o0[4 * j + 3]);
#pragma unroll
    for (int p = 0; p < NP - 1; ++p) {
#pragma unroll
      for (int j = 0; j < W1 / 8; ++j)
        store(W0 + p * W1 + 8 * j + 2 * t, o1[p][4 * j], o1[p][4 * j + 1],
              o1[p][4 * j + 2], o1[p][4 * j + 3]);
    }
  }
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a 4-d map over (depth, heads, S, B) of a contiguous bf16 tensor, with a
// box of `width` columns (64, 32 or 16: the matching swizzle) by `rows`
CUresult encode(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                int depth, int heads, int s_len, int batch, int width,
                int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(depth),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s_len),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = 2ull * depth;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * s_len};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(width), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      width == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                  : (width == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : CU_TENSOR_MAP_SWIZZLE_32B);
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // zeros past S
}

// raise the kernel's dynamic shared memory limit, once a device
template <int HD, int C>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attention_kernel<HD, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Smem<HD, C>::kBytes);
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out,
           int batch, int s_len, int n_heads, int n_kv_heads, int d_out,
           float scale_log2, int causal, int window, cudaStream_t stream) {
  constexpr int C = kConsumers<HD>;
  using L = Layout<HD>;
  using M = Smem<HD, C>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kEncodeError + CUDA_ERROR_NOT_FOUND;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  for (int p = 0; p < L::kPanels; ++p) {
    const int width = p == 0 ? L::kW0 : L::kW1;
    CUresult r = encode(enc, &maps.q[p], q, HD, n_heads, s_len, batch,
                        width, M::kBQ);
    if (r == CUDA_SUCCESS)
      r = encode(enc, &maps.k[p], k, HD, n_kv_heads, s_len, batch, width,
                 M::kBK);
    if (r == CUDA_SUCCESS)
      r = encode(enc, &maps.v[p], v, HD, n_kv_heads, s_len, batch, width,
                 M::kBK);
    if (r != CUDA_SUCCESS) return kEncodeError + static_cast<int>(r);
  }
  const cudaError_t attr = allow_smem<HD, C>();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(batch * n_heads, (s_len + M::kBQ - 1) / M::kBQ);
  flash_attention_kernel<HD, C><<<grid, (C + 1) * 128, M::kBytes, stream>>>(
      maps, static_cast<__nv_bfloat16*>(out), s_len, n_heads, n_kv_heads,
      d_out, scale_log2, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (batch, s_len, n_heads, depth), k, v (batch, s_len, n_kv_heads,
// depth): bf16, contiguous, 16-byte aligned; out (batch, s_len, n_heads,
// d_out), d_out <= depth (hd 20 runs at depth 32 with d_out 20, hd 112
// at 128 with d_out 112); depth one of 16, 32, 64, 80, 128 and 256.
// scale_log2 = d^-0.5 log2(e) of the true head dim; window <= 0 means no
// window. Returns cudaGetLastError(), kEncodeError + the CUresult of a
// tensor map that failed, or cudaErrorInvalidValue for a depth not
// instantiated.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int s_len, int n_heads, int n_kv_heads,
                                    int depth, int d_out, float scale_log2,
                                    int causal, int window,
                                    cudaStream_t stream) {
  switch (depth) {
#define FLASH_DEPTH(D)                                                     \
  case D:                                                                  \
    return launch<D>(q, k, v, out, batch, s_len, n_heads, n_kv_heads,      \
                     d_out, scale_log2, causal, window, stream);
    FLASH_DEPTH(16)
    FLASH_DEPTH(32)
    FLASH_DEPTH(64)
    FLASH_DEPTH(80)
    FLASH_DEPTH(128)
    FLASH_DEPTH(256)
#undef FLASH_DEPTH
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
