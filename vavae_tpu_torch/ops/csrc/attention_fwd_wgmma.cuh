// Attention forward of the small route on Hopper (sm_90a): the device body
// that nat_attention_fwd.cu (fused qkv; replaces _nat_fwd_kernel) and
// attn_small_fwd.cu (separate q, k, v; replaces _attn_kernel_small_rope and
// _attn_kernel_small, vavae_tpu/ops/pallas/flash_attention.py) launch for
// bf16 inputs with D <= 128, every input row 16-byte aligned (rows_aligned16)
// and N <= 1024 (SMALL_SEQ_MAX): the sampling and training paths at 256².
// attention_fwd() below sends fp32 calls with D <= 128 to the 3xTF32 body of
// attention_tf32.cuh, and every other call (fp32 at D > 128, bf16 at D > 128,
// misaligned views or longer sequences) to the first bodies in
// attention_fwd.cuh, which flash_fwd.cu (the long route) calls directly.
//
// Numerics are those of the first bf16 body and the TPU kernels:
//   q~ = q*cos + rot_half(q)*sin   in bf16, rounded after each operation, the
//                                  fp32 tables rounded to bf16; the sign of
//                                  the split-half sin folded here (negated
//                                  for d < D/2, which is exact)
//   s  = (q~ . k~^T) * D^-0.5      fp32 accumulation, held in log2 units
//                                  (times log2 e) so that exp2f gives exp
//   p  = exp(s - rowmax)           fp32, rounded to bf16 for P.V
//   o  = (P . V) / rowsum(p)       fp32 accumulation, division last, bf16 out
// with the softmax one-pass online over 64-key tiles (fp32 running max and
// sum), as in attention_fwd.cuh.
//
// Bound on an H100 SXM at the main-path shape (B=16, H=16, N=256, D=72):
// q, k, v read once and the output written once, 37.7 MB -> 11.3 us at 3.35
// TB/s, against 4*B*H*N^2*D = 4.83 GFLOP -> 4.9 us at 989 TFLOP/s: the bytes.
//
// Design, against what held the first body (attention_fwd.cuh) at 10x that
// bound: K re-rotated for every 64-query tile with fp32 table reads through
// L2 (about 188 MB of them per call against 37.7 MB of data), loads in line
// with compute under two or three barriers per tile, mma.sync fragments read
// from shared memory by every warp, and 64-query blocks of 128 threads.
//  - One block of two warpgroups (256 threads) per (batch, head, 128
//    queries); each warpgroup owns 64 queries. q~ stays in shared memory.
//    The k~/v tiles of 64 keys stream through a ring of four stages by
//    16-byte cp.async, shared by both warpgroups, tiles t + 1 and t + 2 in
//    flight under tile t's products; each thread owns one row of a streamed
//    tile, so a tile costs it two address updates and up to six copies.
//  - RoPE once per position and head. The blocks of one head form a thread
//    block cluster (N/128 of them, at most 8). Each block rotates the q and
//    k rows of its own 128 positions, one read of the fp32 tables for both
//    (37.7 MB of table reads per call at the main-path shape, where the first
//    body read 188 MB and a rotation of every k tile per block 113 MB), keeps
//    q~ and writes k~ into its own rows of the output; after a cluster
//    barrier every block of the head streams k~ from there, and a second
//    cluster barrier lets the output overwrite those rows once every block is
//    done reading. No other buffer and no other launch: the wrappers pass the
//    model's raw (cos, sin) buffers. The first v tiles load under the rotation.
//  - S = q~ . k~^T on wgmma m64n64k16, both operands in shared memory,
//    K-major (DP/16 k-steps: 5 at D = 72); O += P . V on wgmma m64nDPk16
//    with P as the register-A operand (the score accumulator rounded to bf16
//    in place and packed before the batch) and v read MN-major. These are
//    the descriptor conventions the backward (attention_bwd.cuh) checked on
//    the card; both bodies take them from wgmma_common.cuh.
//  - The softmax runs in registers on the accumulator fragments: keys past N
//    are masked on the last tile only, the row max is taken on the raw scores
//    and the scale folded into exp2f's argument (one fma a score). The output
//    leaves through the warp's own rows of q~'s buffer in 16-byte row chunks.
//  - Grid and occupancy: at DP <= 80 a block takes 100 KB of shared memory
//    (q~ 20 KB, four stages of 20 KB) and at most 128 registers a thread (the
//    launch bound), so two blocks share an SM: 264 slots on 132 SMs for the
//    512 blocks of (16, 16, 256) and of (4, 16, 1024), 1.94 waves, the last
//    94% full, so the grid is one block per item. DP = 128 takes 160 KB and
//    one block per SM.
//  Tiles in shared memory use the core-matrix layout without swizzle
//  (cm_off), which takes any DP that is a multiple of 16.
//  Not done: TMA, warp specialisation, a persistent walk, and overlapping a
//  tile's softmax with the previous tile's P . V inside a warpgroup.
//  pipelines/profile_attention_fwd.py times the body with parts taken out.

#ifndef VAVAE_ATTENTION_FWD_WGMMA_CUH
#define VAVAE_ATTENTION_FWD_WGMMA_CUH

#include "attention_fwd.cuh"
#include "attention_tf32.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kFwdRows = 128;     // queries a block owns: 2 warpgroups x 64
constexpr int kFwdTile = 64;      // keys of a streamed tile
constexpr int kFwdStages = 4;     // ring stages of k~, v tiles
constexpr int kFwdMaxSeq = 1024;  // longest sequence the body takes (SMALL_SEQ_MAX)
constexpr float kLog2e = 1.4426950408889634f;

// four neighbouring floats (one 16-byte load)
__device__ __forceinline__ void load4(const float* p, float (&f)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x;
  f[1] = v.y;
  f[2] = v.z;
  f[3] = v.w;
}

__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<const __nv_bfloat162*>(&u);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The split-half rotation of two neighbouring columns d, d + 1 (lo) and
// their partners d + D/2, d + D/2 + 1 (hi), in bf16x2 arithmetic:
//   lo' = lo*cos[d] - hi*sin[d],  hi' = hi*cos[d + D/2] + lo*sin[d + D/2]
// with the tables rounded to bf16 and one rounding per operation, which is
// rotate_tile_bf16's arithmetic (a product of two bf16 and a sum of two
// bf16 products round the same either way); the minus is the fold of the
// split-half sign.
__device__ __forceinline__ void rope_bf16x2(uint32_t& lo, uint32_t& hi, const float* c0,
                                            const float* c1, const float* s0, const float* s1) {
  const __nv_bfloat162 x = as_bf162(lo), xr = as_bf162(hi);
  const __nv_bfloat162 cl = __floats2bfloat162_rn(c0[0], c0[1]);
  const __nv_bfloat162 ch = __floats2bfloat162_rn(c1[0], c1[1]);
  const __nv_bfloat162 sl = __floats2bfloat162_rn(s0[0], s0[1]);
  const __nv_bfloat162 sh = __floats2bfloat162_rn(s1[0], s1[1]);
  lo = as_u32(__hsub2(__hmul2(x, cl), __hmul2(xr, sl)));
  hi = as_u32(__hadd2(__hmul2(xr, ch), __hmul2(x, sh)));
}

// every thread of the cluster waits here; the writes before it (global and
// shared) are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The forward for 128 queries of one (batch, head); DP = the head dim
// zero-padded to a multiple of 16 (32, 64, 80 or 128); scale_log2 = D^-0.5 *
// log2 e. With RoPE the blocks of one head form a cluster (the grid's x): each
// first rotates the q and k rows of its own 128 positions, reading the tables
// once for both, keeps q~ and writes k~ into its own rows of the output; after
// a cluster barrier every block streams the head's k~ from there. A second
// cluster barrier lets the output overwrite them only once every block of the
// head is done reading.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, DP <= 80 ? 2 : 1)
attn_fwd_wgmma_kernel(View q, View k, View v, View out, const float* __restrict__ cos_t,
                      const float* __restrict__ sin_t, int N, int D, float scale_log2,
                      int use_rope) {
  constexpr int NT = DP / 8;            // 8-column groups of the output
  constexpr int kTile = kFwdTile * DP;  // elements of a streamed k~ or v tile
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* q_s = reinterpret_cast<bf16*>(mma_smem);  // kFwdRows x DP, resident
  bf16* ring = q_s + kFwdRows * DP;               // kFwdStages stages of k~, v tiles

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row group
  const int cq = lane % 4;  // fragment column pair
  const int q0 = blockIdx.x * kFwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bool rope = use_rope != 0;
  const int tiles = (N + kFwdTile - 1) / kFwdTile;
  const int half = D / 2;
  const bf16* __restrict__ qb = head_base<const bf16>(q, b, h);
  // the streamed k~: the head's rows of the output with RoPE, else k itself
  const bf16* __restrict__ kb =
      rope ? head_base<const bf16>(out, b, h) : head_base<const bf16>(k, b, h);
  const long long ksn = rope ? out.sn : k.sn;
  const bf16* __restrict__ vb = head_base<const bf16>(v, b, h);

  // A streamed tile's row tid / 4 belongs to this thread, its 16-byte chunks
  // tid % 4, tid % 4 + 4, ...: the addresses are fixed but for the row's offset.
  const int row = threadIdx.x / 4, part = threadIdx.x % 4;
  bf16* row_s = ring + cm_off<DP>(row, 8 * part);  // stage 0's first chunk of the row
  // tile t's k~ (with_k) and v (with_v) go to stage t % kFwdStages, k~ first
  auto load_tile = [&](int t, bool with_k = true, bool with_v = true) {
    const int n = t * kFwdTile + row;
    if (t < tiles) {
      const bf16* kr = kb + (long long)(n < N ? n : 0) * ksn + 8 * part;
      const bf16* vr = vb + (long long)(n < N ? n : 0) * v.sn + 8 * part;
      bf16* st = row_s + (t % kFwdStages) * 2 * kTile;
#pragma unroll
      for (int c = 0; c < DP / 8; c += 4) {  // chunk part + c: c * 64 elements on in the tile
        const bool in = n < N && 8 * (part + c) < D;
        if (part + c < DP / 8) {
          if (with_k) cp_async16(st + 64 * c, kr + 8 * c, in ? 16 : 0);
          if (with_v) cp_async16(st + kTile + 64 * c, vr + 8 * c, in ? 16 : 0);
        }
      }
    }
  };

  load_rows<kFwdRows, DP, 8>(q_s, qb, q.sn, q0, N, D);
  if (rope) {
    // this block's 128 k rows into the ring's last stage (free until tile 3)
    // and, behind them, the first three v tiles; then q~ and k~ of its
    // positions: an item is row r's columns d..d+3 and their partners
    // d + D/2.., the four table loads shared by q and k
    bf16* k_own = ring + (kFwdStages - 1) * 2 * kTile;
    load_rows<kFwdRows, DP, 8>(k_own, head_base<const bf16>(k, b, h), k.sn, q0, N, D);
    cp_async_commit();
    for (int t = 0; t < kFwdStages - 1; ++t) load_tile(t, false, true);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    bf16* kt = head_base<bf16>(out, b, h);
    const int groups = half / 4;
    for (int idx = threadIdx.x; idx < kFwdRows * groups; idx += kWgThreads) {
      const int r = idx / groups;
      const int d = (idx - r * groups) * 4;
      const int n = q0 + r;
      if (n >= N) continue;
      const float* cos_row = cos_t + n * D;
      const float* sin_row = sin_t + n * D;
      float c0[4], c1[4], s0[4], s1[4];
      load4(cos_row + d, c0);
      load4(cos_row + d + half, c1);
      load4(sin_row + d, s0);
      load4(sin_row + d + half, s1);
      uint2* ql = reinterpret_cast<uint2*>(q_s + cm_off<DP>(r, d));
      uint2* qh = reinterpret_cast<uint2*>(q_s + cm_off<DP>(r, d + half));
      uint2 xl = *ql, xh = *qh;
      rope_bf16x2(xl.x, xh.x, c0, c1, s0, s1);
      rope_bf16x2(xl.y, xh.y, c0 + 2, c1 + 2, s0 + 2, s1 + 2);
      *ql = xl;
      *qh = xh;
      uint2 yl = *reinterpret_cast<const uint2*>(k_own + cm_off<DP>(r, d));
      uint2 yh = *reinterpret_cast<const uint2*>(k_own + cm_off<DP>(r, d + half));
      rope_bf16x2(yl.x, yh.x, c0, c1, s0, s1);
      rope_bf16x2(yl.y, yh.y, c0 + 2, c1 + 2, s0 + 2, s1 + 2);
      *reinterpret_cast<uint2*>(kt + n * out.sn + d) = yl;
      *reinterpret_cast<uint2*>(kt + n * out.sn + d + half) = yh;
    }
    cluster_sync();  // every block of the head has written its k~ rows
    load_tile(0, true, false);
    load_tile(1, true, false);
    cp_async_commit();
    load_tile(2, true, false);
    cp_async_commit();
  } else {
    for (int t = 0; t < kFwdStages - 1; ++t) {
      load_tile(t);
      cp_async_commit();
    }
  }
  const bf16* q_wg = q_s + (warp / 4) * kFwdTile * DP;  // this warpgroup's 64 queries
  cp_async_wait<1>();
  fence_async_smem();
  __syncthreads();  // q and tiles 0, 1 have landed

  float o[NT][4];
#pragma unroll
  for (int u = 0; u < NT; ++u) o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the lane's rows gr and gr + 8
  float l0 = 0.f, l1 = 0.f;              // running sums
  for (int t = 0; t < tiles; ++t) {
    if (t > 0) {
      cp_async_wait<1>();
      fence_async_smem();
      __syncthreads();  // tile t + 1 has landed, tile t - 1 is free
    }
    load_tile(t + 3);  // into tile t - 1's stage, landing under the next two tiles
    cp_async_commit();
    const bf16* k_s = ring + (t % kFwdStages) * 2 * kTile;
    const bf16* v_s = k_s + kTile;

    // s = q~ . k~^T: this warpgroup's 64 queries x the tile's 64 keys
    float s[8][4];
    wgmma_fence();
    gmma_dot<DP>(s, q_wg, k_s);
    wgmma_commit();
    wgmma_wait_all();

    // mask keys past N (the last tile only), online softmax over the four
    // lanes of a row: the max on the raw scores (the scale is positive), the
    // scale into log2 units folded into the exponent's argument
    const int k0 = t * kFwdTile;
    if (k0 + kFwdTile > N) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * cq + (e & 1) >= N) s[j][e] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0 * scale_log2);  // finite: every tile holds a key < N
    const float mn1 = fmaxf(m1, mx1 * scale_log2);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(fmaf(s[j][0], scale_log2, -mn0));
      s[j][1] = exp2f(fmaf(s[j][1], scale_log2, -mn0));
      s[j][2] = exp2f(fmaf(s[j][2], scale_log2, -mn1));
      s[j][3] = exp2f(fmaf(s[j][3], scale_log2, -mn1));
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float alpha0 = exp2f(m0 - mn0);
    const float alpha1 = exp2f(m1 - mn1);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      o[u][0] *= alpha0;
      o[u][1] *= alpha0;
      o[u][2] *= alpha1;
      o[u][3] *= alpha1;
    }

    // o += round(P) . V, P packed before the batch
    uint32_t pa[4][4];
    pack_a(pa, s);
    wgmma_fence();
    gmma_pv<DP>(o, pa, v_s);
    wgmma_commit();
    wgmma_wait_all();
  }

  if (rope) cluster_sync();  // every block of the head is done reading k~ from the output

  // the output leaves through this warp's own 16 rows of q_s (its warpgroup's
  // last product has read them), row-major, so that each row goes out in
  // 16-byte chunks
  bf16* stage = q_s + warp * 16 * DP;
#pragma unroll
  for (int half_row = 0; half_row < 2; ++half_row) {
    const float l = half_row ? l1 : l0;
    bf16* dst = stage + (gr + 8 * half_row) * DP + 2 * cq;
#pragma unroll
    for (int u = 0; u < NT; ++u)
      store_pair(dst + u * 8, o[u][2 * half_row] / l, o[u][2 * half_row + 1] / l);
  }
  __syncwarp();
  bf16* ob = head_base<bf16>(out, b, h);
  const int chunks = D / 8;
  for (int c = lane; c < 16 * chunks; c += 32) {
    const int r = c / chunks;
    const int d = (c - r * chunks) * 8;
    const int n = q0 + warp * 16 + r;
    if (n < N)
      *reinterpret_cast<uint4*>(ob + n * out.sn + d) =
          *reinterpret_cast<const uint4*>(stage + r * DP + d);
  }
}

template <int DP>
cudaError_t launch_fwd_wgmma(const FwdArgs& a) {
  const size_t smem = sizeof(bf16) * (kFwdRows + 2 * kFwdStages * kFwdTile) * DP;
  // once per instance (the process runs on one card): the shared memory allowance
  static const cudaError_t setup = cudaFuncSetAttribute(
      attn_fwd_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (setup != cudaSuccess) return setup;
  const dim3 grid((a.N + kFwdRows - 1) / kFwdRows, a.H, a.B);
  // with RoPE the blocks of a head (at most 8: N <= 1024) form one cluster
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = a.use_rope ? grid.x : 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(kWgThreads);
  config.dynamicSmemBytes = smem;
  config.stream = a.stream;
  config.attrs = cluster;
  config.numAttrs = 1;
  const float scale_log2 = kLog2e / sqrtf((float)a.D);
  const cudaError_t err =
      cudaLaunchKernelEx(&config, attn_fwd_wgmma_kernel<DP>, a.q, a.k, a.v, a.out, a.cos_t,
                         a.sin_t, a.N, a.D, scale_log2, a.use_rope);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the calls the wgmma body takes: bf16 (dtype 1), D <= 128, N <= 1024, every
// input and output row 16-byte aligned (which needs D % 8 == 0) and, with
// RoPE, both tables 16-byte aligned
inline bool takes_wgmma(const FwdArgs& a, int dtype) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return dtype == 1 && valid_shape(a) && a.D <= 128 && a.N <= kFwdMaxSeq &&
         rows_aligned16(a.q, a.D) && rows_aligned16(a.k, a.D) && rows_aligned16(a.v, a.D) &&
         rows_aligned16(a.out, a.D) &&
         (!a.use_rope || (aligned(a.cos_t) && aligned(a.sin_t)));
}

// shared memory of the 3xTF32 forward: q~ and the ring's stages, or the
// merge of the key groups over them
template <int DP>
size_t fwd_tf32_smem(int stages, int D, bool rope) {
  const size_t tiles = (size_t)kTf32FwdRows * (DP + 4) + (size_t)stages * tf32_fwd_stage<DP>(D, rope);
  const size_t merge = tf32_fwd_merge<DP>();
  return sizeof(float) * (tiles > merge ? tiles : merge);
}

template <int DP, int VEC>
cudaError_t launch_fwd_tf32(const FwdArgs& a) {
  // once per instance (the process runs on one card): the shared memory
  // allowance of the most the instance takes (every stage, RoPE, D = DP)
  static const cudaError_t setup = cudaFuncSetAttribute(
      attn_fwd_tf32_kernel<DP, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)fwd_tf32_smem<DP>(tf32_fwd_stages<DP>(), DP, true));
  if (setup != cudaSuccess) return setup;
  const int stages = a.N <= kTf32Tile ? 1 : tf32_fwd_stages<DP>();
  const size_t smem = fwd_tf32_smem<DP>(stages, a.D, a.use_rope != 0);
  const dim3 grid((a.N + kTf32FwdRows - 1) / kTf32FwdRows, a.H, a.B);
  const float scale = 1.0f / sqrtf((float)a.D);
  attn_fwd_tf32_kernel<DP, VEC><<<grid, kTf32FwdThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.out, a.cos_t, a.sin_t, a.N, a.D, scale, a.use_rope, stages);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch_fwd_tf32(const FwdArgs& a) {
  switch (tf32_padded_dim(a.D)) {
    case 32: return launch_fwd_tf32<32, VEC>(a);
    case 64: return launch_fwd_tf32<64, VEC>(a);
    case 72: return launch_fwd_tf32<72, VEC>(a);
    default: return launch_fwd_tf32<128, VEC>(a);
  }
}

// dtype: 0 = float32, 1 = bfloat16. fp32 calls with D <= 128 take the 3xTF32
// body, the bf16 calls that takes_wgmma accepts the wgmma body, every other
// call the first bodies (attention_fwd_mma_sync). Needs B, N, H >= 1 and an
// even D <= 256.
cudaError_t attention_fwd(const FwdArgs& a, int dtype) {
  if (dtype == 0 && valid_shape(a) && a.D <= 128) {
    const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    const bool vec = rows_aligned16(a.q, a.D, 4) && rows_aligned16(a.k, a.D, 4) &&
                     rows_aligned16(a.v, a.D, 4) &&
                     (!a.use_rope || (aligned(a.cos_t) && aligned(a.sin_t)));
    return vec ? dispatch_fwd_tf32<4>(a) : dispatch_fwd_tf32<1>(a);
  }
  if (!takes_wgmma(a, dtype)) return attention_fwd_mma_sync(a, dtype);
  if (a.D <= 32) return launch_fwd_wgmma<32>(a);
  if (a.D <= 64) return launch_fwd_wgmma<64>(a);
  if (a.D <= 80) return launch_fwd_wgmma<80>(a);
  return launch_fwd_wgmma<128>(a);
}

}  // namespace

#endif  // VAVAE_ATTENTION_FWD_WGMMA_CUH
