// Attention forward of the long route on Hopper (sm_90a): the device body
// that flash_fwd.cu (replaces vavae_tpu/ops/pallas/flash_attention.py:
// _flash_kernel) launches for q~, k~ rotated beforehand with bf16 v, D <= 72
// and D % 8 == 0, every row of q~, k~, v and the output 16-byte aligned:
//   q~, k~ fp32 (the RoPE models, both branches; the 1024² main path):
//        q~ . k~^T on TF32 wgmma m64n64k8, fp32 output;
//   q~, k~ bf16 (use_rope: false): q~ . k~^T on bf16 wgmma m64n64k16, bf16
//        output.
// flash_fwd() sends the all-fp32 pair and misaligned views to the first
// bodies in attention_fwd.cuh.
//
// Numerics are those of the first body and the TPU kernel:
//   s = (q~ . k~^T) * D^-0.5     q~, k~ rounded to TF32 (cvt.rna: to
//                                nearest, ties away from zero) as the
//                                mma.sync body rounds them, fp32
//                                accumulation; held in log2 units (times
//                                log2 e) so that 2^x gives exp
//   p = exp(s - rowmax)          fp32 (ex2.approx, results below 2^-126
//                                flushed to zero), rounded to bf16 for P.V
//   o = (P . V) / rowsum(p)      fp32 accumulation, division last, in q~'s
//                                dtype
// with the softmax one-pass online over 64-key tiles (fp32 running max and
// sum). Any N >= 1: keys past N in the last tile are zero-filled and masked.
//
// Bound on an H100 SXM at the main-path shape (B=4, H=16, N=4096, D=72, q~,
// k~ fp32, v bf16, out fp32): q~.k~^T, 2*B*H*N^2*D = 155 GFLOP at TF32's 495
// TFLOP/s, and P.V as much again at bf16's 989: 0.469 ms, against 264 MB of
// inputs and output at 3.35 TB/s, 0.079 ms: the operations.
//
// Design. Every block streams its head's k~ and v from L2, 432 bytes a key
// at D = 72 (fp32 k~), so the L2 bytes fall with the queries a block owns:
// with 128-query blocks (two an SM) the kernel's time followed those bytes.
//  - One block of four warpgroups (512 threads, one an SM) per (batch, head,
//    256 queries), each warpgroup owning 64 queries: 1.8 GB of L2 reads per
//    call at the main-path shape. q~ (74 KB in fp32) stays in shared memory.
//    The grid runs the blocks of one head next to each other, so a head's k~
//    and v (1.8 MB) stay in L2 while they are read.
//  - The k~/v tiles of 64 keys stream through a ring of four stages by
//    16-byte cp.async, two tiles ahead of the products. A warp copies 64
//    contiguous bytes (two whole sectors) of each of 8 rows per instruction,
//    and a quarter-warp's eight chunks land in eight distinct bank quads.
//  - Each stage has two mbarriers instead of a block barrier a tile: full
//    (every thread's chunks of the tile have landed and are rounded) and
//    empty (every warpgroup is done with the tile, so the stage may take the
//    tile kLongStages on). The loads issued at tile t (of tile t + 2) wait
//    for tile t - 2 to be done (one stage is slack), so a warpgroup may run
//    a tile ahead of another: the warpgroups drift apart, and one's softmax
//    runs under another's products. Loading three tiles ahead leaves no
//    slack and holds them in step, one phase at a time.
//  - TF32 rounding: wgmma reads the raw fp32 bits of q~ and k~ and keeps the
//    TF32 ones (truncation), so the thread that copied a chunk rounds it in
//    place (cvt.rna) once it has landed, before the proxy fence that hands
//    it to the tensor cores: q~ once, each k~ tile once per block, the next
//    tile's while this tile's S runs.
//  - S = q~ . k~^T on wgmma m64n64k8 (TF32; m64n64k16 for bf16), both
//    operands in shared memory, K-major as stored: 9 k-steps of 8 at D = 72
//    (5 of 16 for bf16, D padded to 80 with zeros). O += P . V on wgmma
//    m64nDPk16 (DP = 72 or 64: v is not padded) with P as the register-A
//    operand (the score accumulator rounded to bf16 in place and packed
//    before the batch) and v read MN-major: attention_fwd_wgmma.cuh's
//    convention, checked on the card.
//  - The softmax runs in registers on the accumulator fragments: keys past
//    N are masked on the last tile only, the row max is taken on the raw
//    scores and the scale folded into the exponent's argument (one fma a
//    score).
//  - The output leaves from the accumulator registers: each lane writes two
//    neighbouring columns of a row, so a warp's store fills whole 32-byte
//    sectors (fp32).
//  Tiles in shared memory use the core-matrix layout without swizzle
//  (cm_off's, counted in 16-byte chunks). pipelines/profile_attention_fwd.py
//  times the body with parts taken out. Not done: a softmax under the same
//  warpgroup's next S (its registers do not fit 512 threads), TMA multicast
//  to a cluster of blocks (which would halve the L2 bytes again), warp
//  specialisation, a persistent walk.

#ifndef VAVAE_FLASH_FWD_WGMMA_CUH
#define VAVAE_FLASH_FWD_WGMMA_CUH

#include "attention_fwd.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kLongWgs = 4;                  // warpgroups a block, 64 queries each
constexpr int kLongThreads = 128 * kLongWgs;  // 16 warps
constexpr int kLongRows = 64 * kLongWgs;      // queries a block owns
constexpr int kLongTile = 64;    // keys of a streamed tile
constexpr int kLongStages = 4;   // ring stages of k~, v tiles
constexpr int kLongMaxDim = 72;  // widest head dim the body takes

// byte offset of 16-byte chunk ch of row r in a core-matrix tile of CHUNKS
// chunks a row: 8-row groups of CHUNKS core matrices (8 rows x 16 bytes)
// side by side, as cm_off lays out bf16
template <int CHUNKS>
__device__ __forceinline__ int long_off(int r, int ch) {
  return (r >> 3) * (CHUNKS * 128) + ch * 128 + (r & 7) * 16;
}

// Shared memory of the body for q~, k~ of type TQK and a head dim padded to
// DP (64 or 72): q~, then the ring's stages of a k~ tile and a v tile
template <typename TQK, int DP>
struct LongLayout {
  static constexpr bool kTf32 = sizeof(TQK) == 4;
  // 16-byte chunks of a q~, k~ row: DP columns for TF32 (k-steps of 8), a
  // multiple of 16 for bf16 (k-steps of 16)
  static constexpr int kQkChunks = (kTf32 ? DP : (DP + 15) / 16 * 16) * (int)sizeof(TQK) / 16;
  static constexpr int kVChunks = DP / 8;
  static constexpr int kKTile = kLongTile * kQkChunks * 16;
  static constexpr int kStage = kKTile + kLongTile * kVChunks * 16;
  static constexpr int kQWg = 64 * kQkChunks * 16;  // a warpgroup's q~
  // q~, the ring, then a full and an empty mbarrier per stage
  static constexpr int kSmem = kLongWgs * kQWg + kLongStages * kStage + 2 * kLongStages * 8;
};

// 2^x on the SFU, subnormal results flushed to zero
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// four floats of shared memory rounded to TF32 in place
__device__ __forceinline__ void round_tf32_chunk(void* p) {
  float4* f = reinterpret_cast<float4*>(p);
  float4 x = *f;
  x.x = round_tf32(x.x);
  x.y = round_tf32(x.y);
  x.z = round_tf32(x.z);
  x.w = round_tf32(x.w);
  *f = x;
}

// s (this warpgroup's 64 queries x the tile's 64 keys) = q~ . k~^T over
// CHUNKS 16-byte chunks of a row: k-steps of two chunks (8 TF32 or 16 bf16
// columns), both operands K-major (lbo: along the row, sbo: between 8-row
// groups)
template <typename TQK, int CHUNKS>
__device__ __forceinline__ void long_dot(float (&s)[8][4], const void* q, const void* k) {
  const uint64_t dq = gmma_desc(q, 128, CHUNKS * 128), dk = gmma_desc(k, 128, CHUNKS * 128);
#pragma unroll
  for (int ks = 0; ks < CHUNKS / 2; ++ks) {
    if constexpr (sizeof(TQK) == 4) {
      wgmma_tf32_n64(&s[0][0], gmma_step(dq, ks * 256), gmma_step(dk, ks * 256), ks > 0);
    } else {
      wgmma_ss<64, 0, 0>(&s[0][0], gmma_step(dq, ks * 256), gmma_step(dk, ks * 256), ks > 0);
    }
  }
}

// o (64 queries x DP) += round(P) . V: pa holds the packed 64x64 P, v the
// tile's 64 keys (rows) of DP columns, read MN-major (lbo: between 8-key
// groups, sbo: along the row); k-steps of 16 keys
template <int DP>
__device__ __forceinline__ void long_pv(float (&o)[DP / 8][4], const uint32_t (&pa)[4][4],
                                        const void* v) {
  constexpr int kGroup = DP / 8 * 128;  // bytes of 8 keys
  const uint64_t dv = gmma_desc(v, kGroup, 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs<DP, 1>(&o[0][0], pa[kk], gmma_step(dv, kk * 2 * kGroup), 1);
}

// this warpgroup's accumulator registers, pinned after a wgmma wait
template <int ROWS>
__device__ __forceinline__ void fence_acc(float (&acc)[ROWS][4]) {
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) fence_operand(acc[j][e]);
}

// The forward for kLongRows queries of one (batch, head): TQK = float (TF32
// S, fp32 output) or bf16; DP = 64 or 72, the head dim's columns of v and
// the output; scale_log2 = D^-0.5 * log2 e.
template <typename TQK, int DP>
__global__ void __launch_bounds__(kLongThreads, 1)
flash_fwd_wgmma_kernel(View q, View k, View v, View out, int N, int D, float scale_log2) {
  using L = LongLayout<TQK, DP>;
  constexpr int NT = DP / 8;                   // 8-column groups of the output
  constexpr int kEl = 16 / (int)sizeof(TQK);   // q~, k~ columns in a 16-byte chunk
  constexpr int kAhead = kLongStages - 2;      // tiles in flight ahead of the products
  extern __shared__ __align__(16) unsigned char mma_smem[];
  unsigned char* q_s = mma_smem;                  // kLongRows rows, resident
  unsigned char* ring = q_s + kLongWgs * L::kQWg;  // kLongStages stages of k~, v tiles
  // full[i]: every thread's chunks of stage i's tile have landed and are
  // rounded; empty[i]: every warpgroup is done with stage i's tile
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kLongStages * L::kStage);
  uint64_t* empty = full + kLongStages;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row group
  const int cq = lane % 4;  // fragment column pair
  const int q0 = blockIdx.x * kLongRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (N + kLongTile - 1) / kLongTile;
  const TQK* __restrict__ qb = head_base<const TQK>(q, b, h);
  const TQK* __restrict__ kb = head_base<const TQK>(k, b, h);
  const bf16* __restrict__ vb = head_base<const bf16>(v, b, h);

  // A streamed tile's row 8 * (warp % 8) + lane % 8 belongs to this thread,
  // its 16-byte chunks first, first + 8, .. with first = 4 * (warp / 8) +
  // lane / 8: a warp copies chunks of 8 rows, 64 contiguous bytes of each,
  // and a quarter-warp one chunk of each row, into 8 bank quads.
  const int row = 8 * (warp % 8) + lane % 8;
  const int first = 4 * (warp / 8) + lane / 8;
  auto stage = [&](int t) { return ring + (t % kLongStages) * L::kStage; };
  // tile t's k~ and v into its stage
  auto load_tile = [&](int t) {
    if (t >= tiles) return;
    const int n = t * kLongTile + row;
    const TQK* kr = kb + (long long)(n < N ? n : 0) * k.sn;
    const bf16* vr = vb + (long long)(n < N ? n : 0) * v.sn;
    unsigned char* st = stage(t);
#pragma unroll
    for (int ch = first; ch < L::kQkChunks; ch += 8) {
      const bool in = n < N && ch * kEl < D;
      cp_async16(st + long_off<L::kQkChunks>(row, ch), in ? kr + ch * kEl : kb, in ? 16 : 0);
    }
#pragma unroll
    for (int ch = first; ch < L::kVChunks; ch += 8) {
      const bool in = n < N && ch * 8 < D;
      cp_async16(st + L::kKTile + long_off<L::kVChunks>(row, ch), in ? vr + ch * 8 : vb,
                 in ? 16 : 0);
    }
  };
  // this thread's chunks of tile t's k~, landed, rounded to TF32 in place
  auto round_tile = [&](int t) {
    if constexpr (L::kTf32) {
#pragma unroll
      for (int ch = first; ch < L::kQkChunks; ch += 8)
        round_tf32_chunk(stage(t) + long_off<L::kQkChunks>(row, ch));
    }
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < kLongStages; ++i) {
      mbar_init(full + i, kLongThreads);
      mbar_init(empty + i, kLongThreads);
    }
  }
  __syncthreads();  // the mbarriers are set up before any thread arrives
  // q~ (its own group) and the first kAhead tiles; the threads that copied
  // q~ and tile 0 round them
  for (int idx = threadIdx.x; idx < kLongRows * L::kQkChunks; idx += kLongThreads) {
    const int r = idx / L::kQkChunks, ch = idx - r * L::kQkChunks;
    const int n = q0 + r;
    const bool in = n < N && ch * kEl < D;
    cp_async16(q_s + long_off<L::kQkChunks>(r, ch), in ? qb + (long long)n * q.sn + ch * kEl : qb,
               in ? 16 : 0);
  }
  cp_async_commit();
  for (int t = 0; t < kAhead; ++t) {
    load_tile(t);
    cp_async_commit();
  }
  cp_async_wait<kAhead - 1>();
  if constexpr (L::kTf32) {
    for (int idx = threadIdx.x; idx < kLongRows * L::kQkChunks; idx += kLongThreads) {
      const int r = idx / L::kQkChunks;
      round_tf32_chunk(q_s + long_off<L::kQkChunks>(r, idx - r * L::kQkChunks));
    }
  }
  round_tile(0);
  fence_async_smem();
  mbar_arrive(full);  // tile 0's phase also publishes q~
  const unsigned char* q_wg = q_s + (warp / 4) * L::kQWg;  // this warpgroup's 64 queries

  float o[NT][4];
#pragma unroll
  for (int u = 0; u < NT; ++u) o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the lane's rows gr and gr + 8
  float l0 = 0.f, l1 = 0.f;              // running sums
  for (int t = 0; t < tiles; ++t) {
    mbar_wait(full + t % kLongStages, (t / kLongStages) & 1);  // tile t is in place
    // tile u into tile t - 2's stage, once every warpgroup is done with it
    const int u = t + kAhead;
    if (u < tiles) {
      if (u >= kLongStages) mbar_wait(empty + u % kLongStages, (u / kLongStages - 1) & 1);
      load_tile(u);
    }
    cp_async_commit();

    // s = q~ . k~^T: this warpgroup's 64 queries x the tile's 64 keys; the
    // next tile's k~ rounded while it runs
    float s[8][4];
    wgmma_fence();
    long_dot<TQK, L::kQkChunks>(s, q_wg, stage(t));
    wgmma_commit();
    if (t + 1 < tiles) {
      cp_async_wait<kAhead - 1>();  // this thread's copies of tile t + 1 have landed
      round_tile(t + 1);
      fence_async_smem();
      mbar_arrive(full + (t + 1) % kLongStages);
    }
    wgmma_wait_all();
    fence_acc(s);

    // mask keys past N (the last tile only), online softmax over the four
    // lanes of a row: the max on the raw scores (the scale is positive), the
    // scale into log2 units folded into the exponent's argument
    const int k0 = t * kLongTile;
    if (k0 + kLongTile > N) {
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
      s[j][0] = ex2_ftz(fmaf(s[j][0], scale_log2, -mn0));
      s[j][1] = ex2_ftz(fmaf(s[j][1], scale_log2, -mn0));
      s[j][2] = ex2_ftz(fmaf(s[j][2], scale_log2, -mn1));
      s[j][3] = ex2_ftz(fmaf(s[j][3], scale_log2, -mn1));
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float alpha0 = ex2_ftz(m0 - mn0);
    const float alpha1 = ex2_ftz(m1 - mn1);
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
    long_pv<DP>(o, pa, stage(t) + L::kKTile);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(o);
    mbar_arrive(empty + t % kLongStages);  // this thread's warpgroup is done with tile t
  }

  // rows 16 * warp + gr (+ 8) of the block, columns 8u + 2cq (+ 1)
  TQK* ob = head_base<TQK>(out, b, h);
#pragma unroll
  for (int half_row = 0; half_row < 2; ++half_row) {
    const int n = q0 + warp * 16 + gr + 8 * half_row;
    const float l = half_row ? l1 : l0;
    if (n < N) {
#pragma unroll
      for (int u = 0; u < NT; ++u)
        if (u * 8 < D)
          store_pair(ob + (long long)n * out.sn + u * 8 + 2 * cq, o[u][2 * half_row] / l,
                     o[u][2 * half_row + 1] / l);
    }
  }
}

template <typename TQK, int DP>
cudaError_t launch_fwd_long(const FwdArgs& a) {
  constexpr int smem = LongLayout<TQK, DP>::kSmem;
  // once per instance (the process runs on one card): the shared memory allowance
  static const cudaError_t setup = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<TQK, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (setup != cudaSuccess) return setup;
  const dim3 grid((a.N + kLongRows - 1) / kLongRows, a.H, a.B);
  const float scale_log2 = 1.4426950408889634f / sqrtf((float)a.D);
  flash_fwd_wgmma_kernel<TQK, DP><<<grid, kLongThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.out, a.N, a.D, scale_log2);
  return cudaGetLastError();
}

// the calls the body takes: q~, k~ fp32 (qk_dtype 0) or bf16 (1) with bf16 v
// (v_dtype 1), D % 8 == 0 and D <= 72, every row of q~, k~, v and the output
// 16-byte aligned
inline bool takes_long_wgmma(const FwdArgs& a, int qk_dtype, int v_dtype) {
  const int qk_bytes = qk_dtype == 0 ? 4 : 2;
  return (qk_dtype == 0 || qk_dtype == 1) && v_dtype == 1 && valid_shape(a) && a.D % 8 == 0 &&
         a.D <= kLongMaxDim && rows_aligned16(a.q, a.D, qk_bytes) &&
         rows_aligned16(a.k, a.D, qk_bytes) && rows_aligned16(a.v, a.D) &&
         rows_aligned16(a.out, a.D, qk_bytes);
}

// a call that takes_long_wgmma
cudaError_t attention_fwd_long(const FwdArgs& a, int qk_dtype) {
  if (qk_dtype == 0) return a.D <= 64 ? launch_fwd_long<float, 64>(a) : launch_fwd_long<float, 72>(a);
  return a.D <= 64 ? launch_fwd_long<bf16, 64>(a) : launch_fwd_long<bf16, 72>(a);
}

}  // namespace

#endif  // VAVAE_FLASH_FWD_WGMMA_CUH
