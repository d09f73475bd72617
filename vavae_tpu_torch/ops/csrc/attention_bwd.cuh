// Attention backward with in-kernel split-half RoPE, for sm_90a: the device
// body of nat_attention_bwd.cu (fused qkv; replaces the TPU kernel
// _nat_bwd_kernel) and attn_small_bwd.cu (separate q, k, v; replaces
// _attn_bwd_kernel_small), both in vavae_tpu/ops/pallas/flash_attention.py.
// Each reads q, k, v and the output gradient g through their Views, in place,
// and writes dq, dk and dv through theirs.
//
// Numerics follow the TPU kernels (_nat_bwd_kernel, _attn_bwd_kernel_small):
//   q~, k~ = x*cos + roll(x, D/2)*sin'    in the input dtype (sin' sign-folded)
//   s  = (q~ . k~^T) * D^-0.5            fp32 accumulation
//   P  = exp(s - rowmax) / rowsum         fp32, normalised (the TPU kernels'
//                                         backward normalises first)
//   dv = round(P)^T . g                   fp32 accumulation
//   dP = g . v^T                          fp32
//   dS = P o (dP - rowsum(dP o P)) * D^-0.5, rounded to the input dtype
//   dq = dS . k~,  dk = dS^T . q~         fp32 accumulation
//   dq, dk <- x*cos + roll(x*sin', D/2)   the transposed RoPE, in fp32 with
//                                         the fp32 tables
//
// Bound on an H100 SXM at the training shape (B=32, H=16, N=256, D=72, bf16):
// q, k, v, g read once and dq, dk, dv written once, 132.1 MB -> 39.4 us at
// 3.35 TB/s, against 10*B*H*N^2*D = 24.2 GFLOP -> 24.4 us at 989 TFLOP/s: the
// bytes bound it. The TPU kernels hold whole (N, N) fp32 P, dP and dS blocks
// for many heads in VMEM; one head's 256x256 fp32 P alone is over a block's
// shared memory here, so the work is tiled.
//
// bf16 (the training path): four launches on the caller's stream, no atomics;
// every sum runs in a fixed order, so two calls give bit-identical results.
//  1. prep, one block per (batch, head, 64 rows): q~ and k~ rotated once per
//     row, in bf16 as the TPU rounds them, into a (B, H, N, DP) scratch with
//     the head dim zero-padded to DP, a multiple of 16 (72 -> 80); without
//     RoPE the same copy, so the later passes see one 16-byte-aligned layout.
//     Cost: q and k read once and 2*B*H*N*DP bf16 written (about 80 MB and
//     24 us at the bound at the training shape); no streamed tile is rotated
//     again, where the parent rotated every k~ tile 2*N/64 times and every q~
//     tile N/64 times, with fp32 table reads and a block barrier each time.
//  2. stats, one block of two warpgroups per (batch, head, 128 queries): q~
//     and g resident, the k~/v tiles of 64 keys streamed once through a ring
//     of three stages; S and dP once per (query, key) pair, the online row
//     max m, row sum l and rescaled rowsum(exp(s - m) o dP). m, 1/l and delta
//     go to the scratch in 64-row tiles of 3 x 64 floats.
//  3. main, key-major and persistent: one block of two warpgroups per SM
//     walks the (batch, head, 128 keys) items; k~ and v resident, the q~/g
//     tiles of 64 queries and their statistics streamed once through a ring
//     of two stages, and the next item's k~, v and first tile loading during
//     the current item's last tile. Per tile each warpgroup forms S^T and
//     dP^T of its 64 keys, then P^T and dS^T in registers, dv += round(P^T) .
//     g and dk += round(dS^T) . q~; round(dS^T) goes to shared memory, where
//     both warpgroups read it for the item's dq partial dS . k~ (64 queries x
//     DP/2 columns each), stored in fp32. Seven products per pair over passes
//     2 and 3, where the parent ran nine. dk gets the transposed RoPE as it
//     leaves; dv and dk leave through shared memory in 16-byte row chunks.
//  4. dq, one block per (batch, head, 64 queries): the key blocks' fp32
//     partials summed in a fixed order (key block 0 first), the transposed
//     RoPE, bf16 out. The partials, ceil(N/128)*B*H*N*D fp32 written and
//     read (75.5 MB each way at the training shape), are the price of
//     determinism without atomic adds. (Summing them in the main pass, by
//     the item that completes its head, measured slower: that block stalls
//     its SM.)
//  Tiles arrive by 16-byte cp.async: tile t + 1's copy (t + 2's in the stats
//  pass) is in flight while tile t's products run. Tiles whose rows are not
//  16-byte aligned (rows_aligned16) take scalar loads into the same ring.
//  The products run on wgmma m64nNk16 (bf16 in, fp32 accumulate, one
//  instruction per k-step), each warpgroup owning 64 rows: S, dP (and S^T,
//  dP^T) with both operands from shared memory, K-major; dv and dk with A
//  from registers, the accumulator rounded in place into the m16n8k16 A
//  fragment (as FlashAttention-3 does), and B = g or q~ read MN-major through
//  the descriptor's transpose bit; dq with A = dS^T read MN-major from shared
//  memory and B = k~ MN-major. Every bf16 tile in shared memory is in the
//  core-matrix layout without swizzle (8x8 blocks of 128 contiguous bytes;
//  cm_off), which wgmma reads either way and which takes any DP that is a
//  multiple of 16 (the 128-byte swizzle would need DP padded to 128). The
//  128-row blocks of 256 threads replace the parent's 64-row blocks of 128
//  threads, so each streamed tile feeds two warpgroups.
//  Not done: TMA, warp specialisation, swizzled layouts, and overlapping one
//  tile's products with the next tile's softmax; the main pass holds one
//  block per SM (226 registers a thread), so its loads and stores overlap
//  its compute only through the prefetch of the next item.
// fp32 (the micro-Doppler DiTs' training, LoRA steps and likelihood): one
// launch of the 3xTF32 body in attention_tf32.cuh, which holds its design.

#ifndef VAVAE_ATTENTION_BWD_CUH
#define VAVAE_ATTENTION_BWD_CUH

#include <initializer_list>

#include "attention_common.cuh"
#include "attention_tf32.cuh"
#include "wgmma_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 kernels (tensor cores)

constexpr int kBwdRows = 128;     // rows a stats or main block owns: 2 warpgroups x 64
constexpr int kBwdThreads = kWgThreads;  // threads of every bf16 backward block
constexpr int kBwdTile = 64;      // rows of a streamed tile
constexpr int kStatTile = 3 * kBwdTile;  // floats of one query tile's m, 1/l, delta
constexpr int kStatsStages = 3;          // ring stages of the stats pass

// stage a warp's (16, DP) fp32 accumulator into a (rows, DP) fp32 tile
template <int NT, int DP>
__device__ __forceinline__ void stage_acc(float* tile, const float (&acc)[NT][4], int warp,
                                          int gr, int cq) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int d = t * 8 + 2 * cq;
    float* r0 = tile + (warp * 16 + gr) * DP + d;
    float* r1 = r0 + 8 * DP;
    r0[0] = acc[t][0];
    r0[1] = acc[t][1];
    r1[0] = acc[t][2];
    r1[1] = acc[t][3];
  }
}

// The transposed RoPE y = x*cos + roll(x*sin', D/2) of one gradient row on
// the column pair (d, d + D/2), in fp32: x0, x1 = x[d], x[d + D/2]; c0, c1 =
// cos[d], cos[d + D/2]; s0, s1 = sin'[d], sin'[d + D/2]
__device__ __forceinline__ float2 rope_t_pair(float x0, float x1, float c0, float c1, float s0,
                                              float s1) {
  return make_float2(x0 * c0 + x1 * s1, x1 * c1 + x0 * s0);
}

// kBwdRows rows of a staged (kBwdRows, DP) tile to gradient rows n0.. (row
// stride rs), W columns per item in one 2W-byte store (W = 8: rows 16-byte
// aligned, D % 8 == 0); with rope, the transposed RoPE of each column in fp32
template <int W, int DP, typename S>
__device__ __forceinline__ void write_rows(bf16* out, long long rs, const S* tile, int n0, int N,
                                           int D, bool rope, const float* cos_t,
                                           const float* sin_t) {
  const int half = D / 2;
  const int chunks = D / W;
  for (int idx = threadIdx.x; idx < kBwdRows * chunks; idx += kBwdThreads) {
    const int r = idx / chunks;
    const int d = (idx - r * chunks) * W;
    const int n = n0 + r;
    if (n >= N) continue;
    const S* x = tile + r * DP;
    float y[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int c = d + w;
      y[w] = to_float(x[c]);
      if (rope) {  // the first of the pair (c, partner): x*cos + partner*sin'[partner]
        const int p = rope_partner(c, half);
        y[w] = rope_t_pair(y[w], to_float(x[p]), cos_t[n * D + c], 0.f, 0.f, sin_t[n * D + p]).x;
      }
    }
    bf16* dst = out + n * rs + d;
    if constexpr (W == 8) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]),
                                                  pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
    } else {
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(y[0], y[1]);
    }
  }
}

// W neighbouring bf16 of a row (W = 4, 2, 1) as one 2W-byte access
template <int W>
__device__ __forceinline__ void load_w(bf16 (&x)[W], const bf16* p) {
  if constexpr (W == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    x[0] = lo.x;
    x[1] = lo.y;
    x[2] = hi.x;
    x[3] = hi.y;
  } else if constexpr (W == 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

template <int W>
__device__ __forceinline__ void store_w(bf16* p, const float (&y)[W]) {
  if constexpr (W == 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
  } else if constexpr (W == 2) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y[0], y[1]);
  } else {
    p[0] = from_float<bf16>(y[0]);
  }
}

// W neighbouring floats (W = 4, 2, 1) added into x, as one 4W-byte load
template <int W>
__device__ __forceinline__ void add_w(float (&x)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] += v.x;
    x[1] += v.y;
    x[2] += v.z;
    x[3] += v.w;
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] += v.x;
    x[1] += v.y;
  } else {
    x[0] += p[0];
  }
}

// the fp32 table entries d.. and d + D/2.. (W of each) of one row
template <int W>
struct TableW {
  float c0[W], c1[W], s0[W], s1[W];
  __device__ __forceinline__ TableW(const float* ct, const float* st, int half) {
#pragma unroll
    for (int w = 0; w < W; ++w) c0[w] = c1[w] = s0[w] = s1[w] = 0.f;
    add_w<W>(c0, ct);
    add_w<W>(c1, ct + half);
    add_w<W>(s0, st);
    add_w<W>(s1, st + half);
  }
};

// Pass 4 (dq), for 64 queries of one (batch, head): the key blocks' fp32
// partials summed in a fixed order (key block 0 first), the transposed RoPE,
// dq in bf16. An item is W neighbouring columns d.. of the first half and
// their partners d + D/2.. (W = 4: D % 8 == 0 and dq rows 8-byte aligned;
// W = 2: D % 4 == 0).
template <int W>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_dq_sum_kernel(const float* __restrict__ dq_part, View dq, const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t, int B, int N, int H, int D,
                       int use_rope) {
  const int n0 = blockIdx.x * kBwdTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int half = D / 2;
  const int pairs = half / W;
  const int blocks = (N + kBwdRows - 1) / kBwdRows;
  const long long plane = (long long)B * H * N * D;
  const float* part = dq_part + ((long long)b * H + h) * N * D;
  bf16* out = head_base<bf16>(dq, b, h);
  const long long rs = dq.sn;
  const bool rope = use_rope != 0;
#pragma unroll 4  // several items' loads in flight
  for (int idx = threadIdx.x; idx < kBwdTile * pairs; idx += kBwdThreads) {
    const int r = idx / pairs;
    const int d = (idx - r * pairs) * W;
    const int n = n0 + r;
    if (n >= N) continue;
    float x0[W] = {}, x1[W] = {};
    for (int kb = 0; kb < blocks; ++kb) {
      const float* row = part + kb * plane + (long long)n * D + d;
      add_w<W>(x0, row);
      add_w<W>(x1, row + half);
    }
    float y0[W], y1[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      y0[w] = x0[w];
      y1[w] = x1[w];
    }
    if (rope) {
      const TableW<W> tab(cos_t + n * D + d, sin_t + n * D + d, half);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float2 y = rope_t_pair(x0[w], x1[w], tab.c0[w], tab.c1[w], tab.s0[w], tab.s1[w]);
        y0[w] = y.x;
        y1[w] = y.y;
      }
    }
    store_w<W>(out + n * rs + d, y0);
    store_w<W>(out + n * rs + d + half, y1);
  }
}

// Pass 1 (prep): q~ and k~ for 64 rows of one (batch, head) into the
// (B, H, N, DP) scratch, rotated when use_rope with the rounding of
// rotate_tile_bf16 (after each operation, in bf16), zero past D. An item is
// W neighbouring columns d.. of the first half and their partners d + D/2..,
// so each input element is read once (W = 4: D % 8 == 0 and 8-byte aligned
// rows; W = 2: D % 4 == 0 and 4-byte aligned rows), or W zero columns past D.
template <int DP, int W>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_prep_kernel(View q, View k, bf16* __restrict__ qt, bf16* __restrict__ kt,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t, int N,
                     int H, int D, int use_rope) {
  using T = bf16;
  const int n0 = blockIdx.x * kBwdTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int half = D / 2;
  const int pairs = half / W;
  const int per_row = pairs + (DP - D) / W;  // rotation items, then the zero columns
  const long long head = ((long long)b * H + h) * N;
#pragma unroll 4  // several items' loads in flight
  for (int idx = threadIdx.x; idx < 2 * kBwdTile * per_row; idx += kBwdThreads) {
    const int which = idx / (kBwdTile * per_row);  // 0: q, 1: k
    const int rem = idx - which * kBwdTile * per_row;
    const int r = rem / per_row;
    const int i = rem - r * per_row;
    const int n = n0 + r;
    if (n >= N) continue;
    T* out = (which ? kt : qt) + (head + n) * DP;
    if (i >= pairs) {
      const float zero[W] = {};
      store_w<W>(out + D + (i - pairs) * W, zero);
      continue;
    }
    const View& x = which ? k : q;
    const T* row = head_base<const T>(x, b, h) + n * x.sn;
    const int d = i * W;
    T lo[W], hi[W];
    load_w<W>(lo, row + d);
    load_w<W>(hi, row + d + half);
    float y0[W], y1[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
      y0[w] = to_float(lo[w]);
      y1[w] = to_float(hi[w]);
    }
    if (use_rope) {
      const TableW<W> tab(cos_t + n * D + d, sin_t + n * D + d, half);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const float x0 = y0[w], x1 = y1[w];
        y0[w] = round_to<T>(x0 * round_to<T>(tab.c0[w])) + round_to<T>(x1 * round_to<T>(tab.s0[w]));
        y1[w] = round_to<T>(x1 * round_to<T>(tab.c1[w])) + round_to<T>(x0 * round_to<T>(tab.s1[w]));
      }
    }
    store_w<W>(out + d, y0);
    store_w<W>(out + d + half, y1);
  }
}

// Pass 2 (stats), for 128 queries: one stream of the k~/v tiles gives the row
// max m, the inverse row sum 1/l and delta = rowsum(dP o P) of each query,
// stored per 64-query tile as m[64], 1/l[64], delta[64] (zeros past N). Each
// warpgroup owns 64 queries.
template <int DP, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_stats_kernel(View qt, View kt, View v, View g, float* __restrict__ stats, int N, int H,
                      int D, float scale) {
  constexpr int kTile = kBwdTile * DP;  // elements of a streamed tile
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(mma_smem);  // kBwdRows x DP, resident
  bf16* g_s = q_s + kBwdRows * DP;                // kBwdRows x DP, resident
  bf16* ring = g_s + kBwdRows * DP;               // kStatsStages stages of k~, v tiles

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row group
  const int cq = lane % 4;  // fragment column pair
  const int q0 = blockIdx.x * kBwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* __restrict__ qb = head_base<const bf16>(qt, b, h);
  const bf16* __restrict__ kb = head_base<const bf16>(kt, b, h);
  const bf16* __restrict__ vb = head_base<const bf16>(v, b, h);
  const bf16* __restrict__ gb = head_base<const bf16>(g, b, h);

  const int tiles = (N + kBwdTile - 1) / kBwdTile;
  // tile t's k~ and v go to stage t % kStatsStages, one cp.async group per
  // tile (the first also holds the resident rows); empty groups keep the count
  auto load_tile = [&](int t) {
    if (t < tiles) {
      bf16* st = ring + (t % kStatsStages) * 2 * kTile;
      load_rows<kBwdTile, DP, VEC>(st, kb, kt.sn, t * kBwdTile, N, D);
      load_rows<kBwdTile, DP, VEC>(st + kTile, vb, v.sn, t * kBwdTile, N, D);
    }
    cp_async_commit();
  };
  load_rows<kBwdRows, DP, VEC>(q_s, qb, qt.sn, q0, N, D);
  load_rows<kBwdRows, DP, VEC>(g_s, gb, g.sn, q0, N, D);
#pragma unroll
  for (int t = 0; t < kStatsStages - 1; ++t) load_tile(t);
  const bf16* q_wg = q_s + (warp / 4) * kTile;  // this warpgroup's 64 queries
  const bf16* g_wg = g_s + (warp / 4) * kTile;

  // online row max, row sum and sum of exp(s - m) * dP, for the lane's rows
  // gr and gr + 8 of the warp's 16
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, e0 = 0.f, e1 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kStatsStages - 2>();
    fence_async_smem();
    __syncthreads();  // tile t has landed, and every warp is done with tile t - 1
    load_tile(t + kStatsStages - 1);  // in flight under this tile's products
    const bf16* k_s = ring + (t % kStatsStages) * 2 * kTile;
    const bf16* v_s = k_s + kTile;
    const int k0 = t * kBwdTile;
    float s[8][4], dp[8][4];
    wgmma_fence();
    gmma_dot<DP>(s, q_wg, k_s);
    gmma_dot<DP>(dp, g_wg, v_s);
    wgmma_commit();
    wgmma_wait_all();
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + j * 8 + 2 * cq + (e & 1) < N;
        s[j][e] = valid ? s[j][e] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);  // finite: every tile holds a key < N
    const float mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f, dsum0 = 0.f, dsum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float x0 = expf(s[j][0] - mn0), x1 = expf(s[j][1] - mn0);
      const float x2 = expf(s[j][2] - mn1), x3 = expf(s[j][3] - mn1);
      sum0 += x0 + x1;
      sum1 += x2 + x3;
      dsum0 += x0 * dp[j][0] + x1 * dp[j][1];
      dsum1 += x2 * dp[j][2] + x3 * dp[j][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    dsum0 += __shfl_xor_sync(0xffffffffu, dsum0, 1);
    dsum0 += __shfl_xor_sync(0xffffffffu, dsum0, 2);
    dsum1 += __shfl_xor_sync(0xffffffffu, dsum1, 1);
    dsum1 += __shfl_xor_sync(0xffffffffu, dsum1, 2);
    const float alpha0 = expf(m0 - mn0);
    const float alpha1 = expf(m1 - mn1);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    e0 = e0 * alpha0 + dsum0;
    e1 = e1 * alpha1 + dsum1;
    m0 = mn0;
    m1 = mn1;
  }

  // lanes of a quad hold the same values; rows past N store zeros, so the
  // main pass gives their P (and dS) 0
  if (cq == 0) {
    float* head = stats + ((long long)b * H + h) * tiles * kStatTile;
#pragma unroll
    for (int half_row = 0; half_row < 2; ++half_row) {
      const int n = q0 + warp * 16 + gr + 8 * half_row;
      if (n / kBwdTile >= tiles) continue;
      const bool in = n < N;
      const float l = half_row ? l1 : l0;
      const float il = 1.0f / l;
      float* at = head + (n / kBwdTile) * kStatTile + n % kBwdTile;
      at[0] = in ? (half_row ? m1 : m0) : 0.f;
      at[kBwdTile] = in ? il : 0.f;
      at[2 * kBwdTile] = in ? (half_row ? e1 : e0) * il : 0.f;
    }
  }
}

// Pass 3 (main), key-major and persistent: each block walks work items, one
// per (128 keys, head, batch), stepping by the grid size. k~ and v of the
// item stay resident while the q~/g tiles of 64 queries and their statistics
// stream through; during an item's last tile the next item's k~, v and first
// tile are already loading, into the other resident buffer and the free ring
// stage. Each warpgroup owns 64 keys, whose dv and dk accumulate in
// registers, and forms half of the DP columns of each query tile's dq partial
// over the item's 128 keys, stored to dq_part[key block][b][h][n][d] in fp32.
template <int DP, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
attn_bwd_main_kernel(View qt, View kt, View v, View g, View dk, View dv,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                     const float* __restrict__ stats, float* __restrict__ dq_part, int B, int N,
                     int H, int D, float scale, int use_rope, int wide_out) {
  constexpr int NT = DP / 8;          // 8-column groups of dk, dv
  constexpr int NTQ = NT / 2;         // 8-column groups of a warpgroup's half of dq
  constexpr int kTile = kBwdTile * DP;
  constexpr int kRes = 2 * kBwdRows * DP;  // elements of one resident k~, v pair
  constexpr int kStage = 2 * kTile * 2 + kStatTile * 4;  // bytes: q~, g, statistics
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* res = reinterpret_cast<bf16*>(mma_smem);  // 2 buffers of k~, v (kBwdRows x DP each)
  bf16* ds_s = res + 2 * kRes;  // round(dS^T), kBwdRows x 64; then dv, kBwdRows x DP
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(ds_s + kBwdRows * (DP > kBwdTile ? DP : kBwdTile));

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int cq = lane % 4;
  const int wg = warp / 4;
  const int blocks = (N + kBwdRows - 1) / kBwdRows;  // key blocks of a head
  const int items = blocks * H * B;
  const int tiles = (N + kBwdTile - 1) / kBwdTile;
  const bool rope = use_rope != 0;

  // item w: key block w % blocks of head (w / blocks) % H of batch w / (blocks * H)
  auto load_resident = [&](int w, bf16* dst) {
    const int kb = w % blocks, h = (w / blocks) % H, b = w / (blocks * H);
    load_rows<kBwdRows, DP, VEC>(dst, head_base<const bf16>(kt, b, h), kt.sn, kb * kBwdRows, N, D);
    load_rows<kBwdRows, DP, VEC>(dst + kBwdRows * DP, head_base<const bf16>(v, b, h), v.sn,
                                 kb * kBwdRows, N, D);
  };
  // ring stage s: q~ rows, g rows, then m, 1/l, delta of query tile t
  auto load_stage = [&](int w, int t, int s) {
    const int h = (w / blocks) % H, b = w / (blocks * H);
    bf16* qs = reinterpret_cast<bf16*>(ring + s * kStage);
    load_rows<kBwdTile, DP, VEC>(qs, head_base<const bf16>(qt, b, h), qt.sn, t * kBwdTile, N, D);
    load_rows<kBwdTile, DP, VEC>(qs + kTile, head_base<const bf16>(g, b, h), g.sn, t * kBwdTile,
                                 N, D);
    float* sts = reinterpret_cast<float*>(qs + 2 * kTile);
    const float* src = stats + (((long long)b * H + h) * tiles + t) * kStatTile;
    for (int c = threadIdx.x; c < kStatTile / 4; c += kBwdThreads)
      cp_async16(sts + 4 * c, src + 4 * c, 16);
  };

  int w = blockIdx.x;
  if (w >= items) return;
  load_resident(w, res);
  load_stage(w, 0, 0);
  int stage = 0;  // ring stage of the current tile
  for (int buf = 0; w < items; w += gridDim.x, buf ^= 1) {
    const int kb = w % blocks, h = (w / blocks) % H, b = w / (blocks * H);
    const int k0 = kb * kBwdRows;
    bf16* k_s = res + buf * kRes;
    const bf16* k_wg = k_s + wg * kTile;  // this warpgroup's 64 keys
    const bf16* v_wg = k_s + kBwdRows * DP + wg * kTile;
    // the lane's two key rows; keys past N get P = dS = 0 (their k~ row is
    // 0, which gives s = 0, not P = 0)
    const bool kin0 = k0 + warp * 16 + gr < N;
    const bool kin1 = k0 + warp * 16 + gr + 8 < N;
    // dq = dS . k~: A = dS^T in ds_s read MN-major (M = queries, K = keys),
    // B = the resident k~ read MN-major from this warpgroup's first column
    const uint64_t dq_a = gmma_desc(ds_s, kBwdTile * 16, 128);
    const uint64_t dq_b = gmma_desc(k_s + cm_off<DP>(0, wg * (DP / 2)), DP * 16, 128);
    float* part = dq_part + (((long long)kb * B + b) * H + h) * N * D;

    float dv_acc[NT][4], dk_acc[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[t][e] = dk_acc[t][e] = 0.f;

    for (int t = 0; t < tiles; ++t, stage ^= 1) {
      cp_async_wait_all();
      fence_async_smem();
      __syncthreads();  // tile t has landed; every warp is done with tile t - 1 and ds_s
      if (t + 1 < tiles) {
        load_stage(w, t + 1, stage ^ 1);
      } else if (w + gridDim.x < items) {  // the next item, under this tile and the epilogue
        load_resident(w + gridDim.x, res + (buf ^ 1) * kRes);
        load_stage(w + gridDim.x, 0, stage ^ 1);
      }
      const bf16* qs = reinterpret_cast<const bf16*>(ring + stage * kStage);
      const bf16* gs = qs + kTile;
      const float* m_s = reinterpret_cast<const float*>(qs + 2 * kTile);
      const float* il_s = m_s + kBwdTile;
      const float* dl_s = il_s + kBwdTile;
      const int q0 = t * kBwdTile;

      // P^T and dP^T: this warpgroup's 64 keys x the tile's 64 queries
      float pt[8][4], dpt[8][4];
      wgmma_fence();
      gmma_dot<DP>(pt, k_wg, qs);
      gmma_dot<DP>(dpt, v_wg, gs);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * cq + (e & 1);
          const bool in = (e < 2 ? kin0 : kin1) && q0 + c < N;
          const float p = in ? expf(pt[j][e] * scale - m_s[c]) * il_s[c] : 0.f;
          pt[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - dl_s[c]) * scale;  // dS^T
        }
      uint32_t pa[4][4], sa[4][4];  // round(P^T), round(dS^T)
      pack_a(pa, pt);
      pack_a(sa, dpt);
      wgmma_fence();
      gmma_pv<DP>(dv_acc, pa, gs);
      gmma_pv<DP>(dk_acc, sa, qs);
      wgmma_commit();
      // meanwhile round(dS^T) goes to shared memory for the dq product, which
      // contracts over the keys of both warpgroups
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = warp * 16 + gr + 8 * (i & 1), c = kk * 16 + 8 * (i >> 1) + 2 * cq;
          *reinterpret_cast<uint32_t*>(ds_s + cm_off<kBwdTile>(r, c)) = sa[kk][i];
        }
      wgmma_wait_all();
      fence_async_smem();
      __syncthreads();

      // dq partial (the tile's 64 queries, this warpgroup's DP/2 columns)
      // over the 128 keys, eight k-steps of 16 keys
      float dq[NTQ][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBwdRows / 16; ++kk)
        wgmma_ss<DP / 2, 1, 1>(&dq[0][0], gmma_step(dq_a, kk * 2 * kBwdTile * 16),
                               gmma_step(dq_b, kk * 2 * DP * 16), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int half_row = 0; half_row < 2; ++half_row) {
        const int n = q0 + (warp % 4) * 16 + gr + 8 * half_row;
        if (n >= N) continue;
#pragma unroll
        for (int u = 0; u < NTQ; ++u) {
          const int d = wg * (DP / 2) + u * 8 + 2 * cq;  // even, and D is even: d < D covers d + 1
          if (d < D)
            *reinterpret_cast<float2*>(part + (long long)n * D + d) =
                make_float2(dq[u][2 * half_row], dq[u][2 * half_row + 1]);
        }
      }
    }

    // dv (rounded to bf16) and dk (fp32, for its transposed RoPE) leave
    // through shared memory, over this item's resident tiles and ds_s, so
    // that each thread writes whole row chunks
    __syncthreads();  // every warp is done with this item's k~, v and ds_s
    float* dk_s = reinterpret_cast<float*>(k_s);  // kBwdRows x DP: the size of k~ and v
    bf16* dv_s = ds_s;                            // kBwdRows x DP
    stage_acc<NT, DP>(dk_s, dk_acc, warp, gr, cq);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      bf16* row = dv_s + (warp * 16 + gr) * DP + t * 8 + 2 * cq;
      *reinterpret_cast<uint32_t*>(row) = pack_bf16(dv_acc[t][0], dv_acc[t][1]);
      *reinterpret_cast<uint32_t*>(row + 8 * DP) = pack_bf16(dv_acc[t][2], dv_acc[t][3]);
    }
    __syncthreads();
    if (wide_out) {
      write_rows<8, DP>(head_base<bf16>(dv, b, h), dv.sn, dv_s, k0, N, D, false, cos_t, sin_t);
      write_rows<8, DP>(head_base<bf16>(dk, b, h), dk.sn, dk_s, k0, N, D, rope, cos_t, sin_t);
    } else {
      write_rows<2, DP>(head_base<bf16>(dv, b, h), dv.sn, dv_s, k0, N, D, false, cos_t, sin_t);
      write_rows<2, DP>(head_base<bf16>(dk, b, h), dk.sn, dk_s, k0, N, D, rope, cos_t, sin_t);
    }

  }
}

// ---------------------------------------------------------------------------
// launches

// q, k, v, g: inputs; dq, dk, dv: outputs with 4-byte aligned rows (the
// wrappers allocate them), each written whole; cos, sin: (N, D) fp32 tables
// (sin sign-folded), read only when use_rope; scratch: bwd_scratch_bytes(...)
// bytes, 256-byte aligned.
struct BwdArgs {
  View q, k, v, g, dq, dk, dv;
  const float* cos_t;
  const float* sin_t;
  void* scratch;
  int B, N, H, D, use_rope;
  cudaStream_t stream;
};

// the head dim zero-padded to the bf16 kernels' product depth
inline int bwd_padded_dim(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : D <= 80 ? 80 : 128; }

inline size_t align256(size_t bytes) { return (bytes + 255) / 256 * 256; }

// The scratch the backward needs. fp32: none for N <= 64 (one tile a head);
// for longer heads q~, k~ and dq's sum over key tiles as (B, H, N, DP) fp32
// and the statistics (B, H, 3, N). bf16: the statistics in 64-query tiles,
// q~ and k~ as (B, H, N, DP) bf16 and the dq partials (ceil(N/128), B, H, N,
// D) fp32.
inline size_t bwd_scratch_bytes(int B, int N, int H, int D, int dtype) {
  const size_t heads = (size_t)B * H;
  if (dtype != 1) {
    if (N <= kTf32Tile) return 0;
    return 3 * align256(sizeof(float) * heads * N * tf32_padded_dim(D)) +
           align256(sizeof(float) * 3 * heads * N);
  }
  const size_t tiles = (N + kBwdTile - 1) / kBwdTile, blocks = (N + kBwdRows - 1) / kBwdRows;
  return align256(sizeof(float) * heads * tiles * kStatTile) +
         2 * align256(sizeof(bf16) * heads * N * bwd_padded_dim(D)) +
         align256(sizeof(float) * blocks * heads * N * D);
}

// the widest W (4, 2 or 1 columns) whose 2W-byte accesses the rows of every
// view allow, with D % (2W) == 0 so that the partner columns d + D/2 align too
inline int column_width(int D, std::initializer_list<View> views) {
  for (int w = 4; w > 1; w /= 2) {
    bool ok = D % (2 * w) == 0;
    for (const View& v : views)
      ok = ok && reinterpret_cast<uintptr_t>(v.ptr) % (2 * w) == 0 && v.sb % w == 0 &&
           v.sn % w == 0 && v.sh % w == 0;
    if (ok) return w;
  }
  return 1;
}

template <int DP, int W>
cudaError_t launch_prep(const BwdArgs& a, bf16* q_buf, bf16* k_buf) {
  const dim3 grid((a.N + kBwdTile - 1) / kBwdTile, a.H, a.B);
  attn_bwd_prep_kernel<DP, W><<<grid, kBwdThreads, 0, a.stream>>>(
      a.q, a.k, q_buf, k_buf, a.cos_t, a.sin_t, a.N, a.H, a.D, a.use_rope);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_dq_sum(const BwdArgs& a, const float* dq_part) {
  const dim3 grid((a.N + kBwdTile - 1) / kBwdTile, a.H, a.B);
  attn_bwd_dq_sum_kernel<W><<<grid, kBwdThreads, 0, a.stream>>>(
      dq_part, a.dq, a.cos_t, a.sin_t, a.B, a.N, a.H, a.D, a.use_rope);
  return cudaGetLastError();
}

template <int DP, int VEC>
cudaError_t launch_bwd_passes(const BwdArgs& a, const View& qt, const View& kt, float* stats,
                              float* dq_part) {
  const size_t smem_stats = sizeof(bf16) * (2 * kBwdRows + 2 * kStatsStages * kBwdTile) * DP;
  const size_t smem_main =
      sizeof(bf16) * (6 * kBwdRows * DP + kBwdRows * (DP > kBwdTile ? DP : kBwdTile)) +
      2 * sizeof(float) * kStatTile;
  const float scale = 1.0f / sqrtf((float)a.D);
  const dim3 grid((a.N + kBwdRows - 1) / kBwdRows, a.H, a.B);
  // once per instance (the process runs on one card): both passes' shared
  // memory allowance, and the blocks the SMs hold at once of the main pass,
  // which is persistent
  static const struct Setup { cudaError_t err; int resident; } setup = [&] {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(attn_bwd_stats_kernel<DP, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_stats);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(attn_bwd_main_kernel<DP, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_main);
    if (e == cudaSuccess) e = cudaGetDevice(&device);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, attn_bwd_main_kernel<DP, VEC>,
                                                        kBwdThreads, smem_main);
    return Setup{e, per_sm * sms};
  }();
  if (setup.err != cudaSuccess) return setup.err;
  attn_bwd_stats_kernel<DP, VEC><<<grid, kBwdThreads, smem_stats, a.stream>>>(
      qt, kt, a.v, a.g, stats, a.N, a.H, a.D, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int items = grid.x * grid.y * grid.z;
  const int blocks = setup.resident < items ? setup.resident : items;
  if (blocks < 1) return cudaErrorInvalidConfiguration;
  attn_bwd_main_kernel<DP, VEC><<<blocks, kBwdThreads, smem_main, a.stream>>>(
      qt, kt, a.v, a.g, a.dk, a.dv, a.cos_t, a.sin_t, stats, dq_part, a.B, a.N, a.H, a.D, scale,
      a.use_rope, rows_aligned16(a.dk, a.D) && rows_aligned16(a.dv, a.D));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_bwd_bf16(const BwdArgs& a) {
  const size_t heads = (size_t)a.B * a.H;
  const size_t tiles = (a.N + kBwdTile - 1) / kBwdTile;
  char* at = static_cast<char*>(a.scratch);
  float* stats = reinterpret_cast<float*>(at);
  at += align256(sizeof(float) * heads * tiles * kStatTile);
  bf16* q_buf = reinterpret_cast<bf16*>(at);
  at += align256(sizeof(bf16) * heads * a.N * DP);
  bf16* k_buf = reinterpret_cast<bf16*>(at);
  at += align256(sizeof(bf16) * heads * a.N * DP);
  float* dq_part = reinterpret_cast<float*>(at);

  // q~, k~: the prep pass's (B, H, N, DP) copies, whose rows cp.async takes
  const long long sh = (long long)a.N * DP;
  const View qt{q_buf, a.H * sh, DP, sh}, kt{k_buf, a.H * sh, DP, sh};
  const int w = column_width(a.D, {a.q, a.k});
  cudaError_t err = w == 4   ? launch_prep<DP, 4>(a, q_buf, k_buf)
                    : w == 2 ? launch_prep<DP, 2>(a, q_buf, k_buf)
                             : launch_prep<DP, 1>(a, q_buf, k_buf);
  if (err != cudaSuccess) return err;
  const bool vec8 = rows_aligned16(a.v, a.D) && rows_aligned16(a.g, a.D);
  err = vec8 ? launch_bwd_passes<DP, 8>(a, qt, kt, stats, dq_part)
             : launch_bwd_passes<DP, 1>(a, qt, kt, stats, dq_part);
  if (err != cudaSuccess) return err;
  const int w_dq = column_width(a.D, {a.dq});
  return w_dq == 4 ? launch_dq_sum<4>(a, dq_part)
                   : w_dq == 2 ? launch_dq_sum<2>(a, dq_part) : launch_dq_sum<1>(a, dq_part);
}

template <int DP, int VEC, bool SINGLE>
cudaError_t launch_bwd_tf32(const BwdArgs& a) {
  constexpr size_t smem = sizeof(float) * tf32_bwd_smem_floats<DP, SINGLE>();
  // once per instance (the process runs on one card): the shared memory allowance
  static const cudaError_t setup =
      cudaFuncSetAttribute(attn_bwd_tf32_kernel<DP, VEC, SINGLE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (setup != cudaSuccess) return setup;
  // the scratch of heads longer than one tile (bwd_scratch_bytes' layout)
  const size_t plane = align256(sizeof(float) * a.B * a.H * a.N * DP);
  char* at = static_cast<char*>(a.scratch);
  float* qt = reinterpret_cast<float*>(at);
  float* kt = reinterpret_cast<float*>(at + plane);
  float* dqa = reinterpret_cast<float*>(at + 2 * plane);
  float* st = reinterpret_cast<float*>(at + 3 * plane);
  const float scale = 1.0f / sqrtf((float)a.D);
  attn_bwd_tf32_kernel<DP, VEC, SINGLE><<<dim3(1, a.H, a.B), tf32_bwd_threads<SINGLE>(), smem,
                                          a.stream>>>(
      a.q, a.k, a.v, a.g, a.dq, a.dk, a.dv, a.cos_t, a.sin_t, qt, kt, dqa, st, a.N, a.H, a.D,
      scale, a.use_rope);
  return cudaGetLastError();
}

template <int VEC, bool SINGLE>
cudaError_t dispatch_bwd_tf32(const BwdArgs& a) {
  switch (tf32_padded_dim(a.D)) {
    case 32: return launch_bwd_tf32<32, VEC, SINGLE>(a);
    case 64: return launch_bwd_tf32<64, VEC, SINGLE>(a);
    case 72: return launch_bwd_tf32<72, VEC, SINGLE>(a);
    default: return launch_bwd_tf32<128, VEC, SINGLE>(a);
  }
}

// dtype: 0 = float32 (the 3xTF32 body), 1 = bfloat16 (the wgmma passes).
// Needs B, N, H >= 1 and an even D <= 128.
cudaError_t attention_bwd(const BwdArgs& a, int dtype) {
  if (a.B < 1 || a.N < 1 || a.H < 1 || a.D < 2 || a.D > 128 || (a.D & 1))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const bool vec = rows_aligned16(a.q, a.D, 4) && rows_aligned16(a.k, a.D, 4) &&
                     rows_aligned16(a.v, a.D, 4) && rows_aligned16(a.g, a.D, 4) &&
                     (!a.use_rope || (aligned(a.cos_t) && aligned(a.sin_t)));
    if (a.N <= kTf32Tile) return vec ? dispatch_bwd_tf32<4, true>(a) : dispatch_bwd_tf32<1, true>(a);
    return vec ? dispatch_bwd_tf32<4, false>(a) : dispatch_bwd_tf32<1, false>(a);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  switch (bwd_padded_dim(a.D)) {
    case 32: return launch_bwd_bf16<32>(a);
    case 64: return launch_bwd_bf16<64>(a);
    case 80: return launch_bwd_bf16<80>(a);
    default: return launch_bwd_bf16<128>(a);
  }
}

}  // namespace

#endif  // VAVAE_ATTENTION_BWD_CUH
