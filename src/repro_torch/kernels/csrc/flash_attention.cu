// Causal / windowed online-softmax attention, forward only, bf16 in and
// out with fp32 scores and state: out(B, S, H, d) from q(B, S, H, d) and
// k, v(B, S, KH, d), query head h reading kv head h / (H / KH).
//
// Replaces the Pallas kernel repro/kernels/flash_attention.py:77
// flash_attention (body _flash_kernel, :31) and its GQA wrapper
// flash_attention_gqa (:113), which repeats the kv heads in HBM first;
// here each block indexes its kv head instead, so nothing is repeated.
//
// Bound: operations. Causal attention at S = 4096, d = 64 does ~350
// flops per byte of q, k, v and out, above the card's ~295 bf16 flops
// per byte, so the tensor cores are the limit, and only warpgroup MMA
// (wgmma) with TMA reaches their full rate. This first kernel takes the
// simpler mma.sync.m16n8k16 (bf16 operands, fp32 accumulation), with
// plain synchronous loads; wgmma, TMA and a pipelined ring of kv tiles
// are later work.
//
// Design: one block of four warps owns one (batch x head, 64-row q tile)
// and loops over the 64-key kv tiles in order, with K and V staged in
// shared memory; each warp owns 16 query rows, keeps its Q fragments, the
// 16 x 64 score tile and the 16 x d output accumulator in registers, and
// the running max and sum of its rows. No atomics: every output is
// written once by one thread, so runs are deterministic. Per kv tile, as
// the Pallas body does per kv block: s = q k^T * d^-0.5 in fp32; masked
// entries -1e30 (kpos <= qpos when causal, kpos > qpos - window with a
// window); m_new = max(m, rowmax s); p = exp(s - m_new); corr = exp(m -
// m_new); l = l corr + sum p (fp32 p); acc = acc corr + bf16(p) v. The
// output is acc / max(l, 1e-30), rounded to bf16. kv tiles that lie
// wholly outside the causal and window band of the whole q tile are
// skipped: the reference issues them, but a fully masked tile only adds
// exp(0) terms that the first valid tile wipes through corr = 0, and
// every row has a valid key (its own), so the function is the same. Keys
// past S (a ragged last tile) are masked and add nothing. Head dims 16,
// 20, 64, 80 and 128 are instantiated; d = 20 is zero-padded to 32
// inside the block.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;            // query rows per block (16 per warp)
constexpr int kBK = 64;            // keys per kv tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kNTiles = kBK / 8;   // n8 tiles of the 16 x 64 score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

// d = a(16x16, row) * b(16x8, col) + c; bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// DP: the head dim padded to a multiple of 16 (the mma's depth)
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ out, int s_len,
                       int n_heads, int n_kv_heads, int d, float scale,
                       int causal, int window) {
  constexpr int kStride = DP + 8;  // bf16 per smem row: no bank conflicts
  constexpr int kKSteps = DP / 16;
  constexpr int kDTiles = DP / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kBK][kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kBK][kStride];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;          // fragment row (and n) within a tile
  const int t = lane % 4;          // fragment column pair
  // the heaviest causal tiles first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / n_heads;
  const int h = bh % n_heads;
  const int kvh = h / (n_heads / n_kv_heads);
  const int q0 = qt * kBQ;
  const int64_t q_row = static_cast<int64_t>(n_heads) * d;     // elements
  const int64_t kv_row = static_cast<int64_t>(n_kv_heads) * d;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(b) * s_len * q_row
                            + static_cast<int64_t>(h) * d;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * s_len * kv_row
                            + static_cast<int64_t>(kvh) * d;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * s_len * kv_row
                            + static_cast<int64_t>(kvh) * d;

  // this thread's two rows: r0 = warp*16 + g and r1 = r0 + 8
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q fragments (A operand, 16 x DP row-major), zero past S and past d
  uint32_t qa[kKSteps][4];
  {
    auto ld = [&](int row, int col) -> uint32_t {
      if (row >= s_len || col >= d) return 0u;
      return *reinterpret_cast<const uint32_t*>(qb + row * q_row + col);
    };
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = ld(r0, c);
      qa[kk][1] = ld(r1, c);
      qa[kk][2] = ld(r0, c + 8);
      qa[kk][3] = ld(r1, c + 8);
    }
  }

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_row[2] = {kNegInf, kNegInf};
  float l_row[2] = {0.f, 0.f};

  // the kv tiles that hold a key inside the band of some row of the tile
  const int q_last = min(q0 + kBQ - 1, s_len - 1);
  const int n_kt = (s_len + kBK - 1) / kBK;
  const int kt_hi = causal ? min(n_kt - 1, q_last / kBK) : n_kt - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();               // the previous tile's readers are done
    for (int e = threadIdx.x; e < kBK * (DP / 2); e += kThreads) {
      const int row = e / (DP / 2);
      const int col = 2 * (e % (DP / 2));
      uint32_t kw = 0u, vw = 0u;
      if (k0 + row < s_len && col < d) {
        const int64_t off = static_cast<int64_t>(k0 + row) * kv_row + col;
        kw = *reinterpret_cast<const uint32_t*>(kb + off);
        vw = *reinterpret_cast<const uint32_t*>(vb + off);
      }
      *reinterpret_cast<uint32_t*>(&ks[row][col]) = kw;
      *reinterpret_cast<uint32_t*>(&vs[row][col]) = vw;
    }
    __syncthreads();

    // s = q k^T: 8 n-tiles of 8 keys, DP / 16 k-steps each
    float sc[kNTiles][4];
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
      sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const __nv_bfloat16* kr = &ks[n * 8 + g][kk * 16 + 2 * t];
        mma_bf16(sc[n], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // scale, mask, and the tile's row max
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = (i < 2) ? r0 : r1;
        const int kpos = k0 + n * 8 + 2 * t + (i & 1);
        float x = sc[n][i] * scale;
        bool keep = kpos < s_len;
        if (causal) keep = keep && kpos <= qpos;
        if (window > 0) keep = keep && kpos > qpos - window;
        x = keep ? x : kNegInf;
        sc[n][i] = x;
        mx[i >> 1] = fmaxf(mx[i >> 1], x);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_row[r], mx[r]);
      corr[r] = expf(m_row[r] - m_new);
      m_row[r] = m_new;
    }
    // p = exp(s - m_new); a key past S adds nothing
#pragma unroll
    for (int n = 0; n < kNTiles; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + n * 8 + 2 * t + (i & 1);
        const float p = kpos < s_len ? expf(sc[n][i] - m_row[i >> 1]) : 0.f;
        sc[n][i] = p;
        sum[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_row[r] = l_row[r] * corr[r] + sum[r];
    }
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += bf16(p) v: the score tile's accumulators are the A operand
    // of the next product (16 keys = two n8 tiles per k-step)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * kk][0], sc[2 * kk][1]);
      pa[1] = pack_bf16(sc[2 * kk][2], sc[2 * kk][3]);
      pa[2] = pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
      pa[3] = pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      const int j = kk * 16 + 2 * t;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
        const int c = n * 8 + g;
        const uint32_t b0 = pack_raw(vs[j][c], vs[j + 1][c]);
        const uint32_t b1 = pack_raw(vs[j + 8][c], vs[j + 9][c]);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

  // out = acc / max(l, 1e-30), rounded to bf16
  const float l0 = fmaxf(l_row[0], 1e-30f);
  const float l1 = fmaxf(l_row[1], 1e-30f);
  __nv_bfloat16* ob = out + static_cast<int64_t>(b) * s_len * q_row
                      + static_cast<int64_t>(h) * d;
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    const int c = n * 8 + 2 * t;
    if (c >= d) continue;
    if (r0 < s_len)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_row + c) =
          pack_bf16(acc[n][0] / l0, acc[n][1] / l0);
    if (r1 < s_len)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_row + c) =
          pack_bf16(acc[n][2] / l1, acc[n][3] / l1);
  }
}

template <int DP>
int launch(const __nv_bfloat16* q, const __nv_bfloat16* k,
           const __nv_bfloat16* v, __nv_bfloat16* out, int batch, int s_len,
           int n_heads, int n_kv_heads, int d, float scale, int causal,
           int window, cudaStream_t stream) {
  const dim3 grid((s_len + kBQ - 1) / kBQ, batch * n_heads);
  flash_attention_kernel<DP><<<grid, kThreads, 0, stream>>>(
      q, k, v, out, s_len, n_heads, n_kv_heads, d, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (batch, s_len, n_heads, d); k, v: (batch, s_len, n_kv_heads, d),
// all bf16 and contiguous; window <= 0 means no window. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a head dim that is
// not instantiated.
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* out, int batch,
                                    int s_len, int n_heads, int n_kv_heads,
                                    int d, float scale, int causal,
                                    int window, cudaStream_t stream) {
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  switch (d) {
    case 16:
      return launch<16>(qp, kp, vp, op, batch, s_len, n_heads, n_kv_heads,
                        d, scale, causal, window, stream);
    case 20:
      return launch<32>(qp, kp, vp, op, batch, s_len, n_heads, n_kv_heads,
                        d, scale, causal, window, stream);
    case 64:
      return launch<64>(qp, kp, vp, op, batch, s_len, n_heads, n_kv_heads,
                        d, scale, causal, window, stream);
    case 80:
      return launch<80>(qp, kp, vp, op, batch, s_len, n_heads, n_kv_heads,
                        d, scale, causal, window, stream);
    case 128:
      return launch<128>(qp, kp, vp, op, batch, s_len, n_heads, n_kv_heads,
                         d, scale, causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
