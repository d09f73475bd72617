// Attention backward with in-kernel split-half RoPE, for sm_90a: the device
// body of nat_attention_bwd.cu (fused qkv) and attn_small_bwd.cu (separate
// q, k, v). Each reads q, k, v and the output gradient g through their
// Views, in place, and writes dq, dk and dv through theirs.
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
// Design. The TPU kernels hold whole (N, N) fp32 P, dP and dS blocks for many
// heads in VMEM; one head's 256x256 fp32 P alone is over a block's shared
// memory here. So the work is tiled FlashAttention-2 style, in two passes
// with no atomics (the result is deterministic):
//  - pass 1, one block per (batch, head, 64 queries): Q~ and G stay in shared
//    memory while K~/V tiles of 64 keys stream through twice. The first stream
//    keeps the online row max, row sum and the rescaled sum of exp(s)*dP; the
//    second recomputes P and dP, forms dS and accumulates dq = dS . K~. The
//    transposed RoPE is applied to dq in fp32 from shared memory. The row max,
//    row sum and delta = rowsum(dP o P) go to a (3, B, H, N) fp32 scratch.
//  - pass 2, one block per (batch, head, 64 keys): K~ and V stay resident
//    while Q~/G tiles stream through; P^T and dP^T are recomputed directly in
//    key-major form from the stored statistics, and dv = P^T . G,
//    dk = dS^T . Q~ accumulate in registers; dk gets the transposed RoPE.
//  - bf16 (the training path): four warps, 16 rows each, run every product on
//    the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate). The
//    scores stay in registers and are rounded in place into the A operand of
//    the next product; the operands that must be read transposed (K~ for dq,
//    G for dv, Q~ for dk) come through ldmatrix.trans. The head dim is
//    zero-padded to a multiple of 16 inside shared memory only (72 -> 80).
//    Tiles arrive with 16-byte loads when every input's rows are 16-byte
//    aligned, else with scalar loads.
//  - fp32 (tests and checks): the same two passes as 4x4 register-blocked FMAs.
// What keeps it off its bound (bytes, at the training shape): pass 1 streams
// K/V twice for every 64-query tile and pass 2 streams Q/G once for every
// 64-key tile, re-rotating K~ and Q~ each time; P and dP are recomputed in
// both passes; loads and compute do not overlap; and mma.sync reaches a
// fraction of the wgmma rate. wgmma/TMA tiles and a single-pass design are
// the redesign.

#ifndef VAVAE_ATTENTION_BWD_CUH
#define VAVAE_ATTENTION_BWD_CUH

#include "attention_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32 kernels

// acc (rows ty*4+i, columns tx+16*j) of a 64x64 product of two row-major
// tiles a, b contracted over their D columns: s = a . b^T
__device__ __forceinline__ void tile_dot_f32(float (&s)[4][4], const float* a, const float* b,
                                             int ld, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * ld + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * ld + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// acc[i][j] += sum_c p[(ty*4+i), c] * x[c, tx+16j] over the 64 rows c of x
template <int NJ>
__device__ __forceinline__ void tile_pv_f32(float (&acc)[4][NJ], const float* p, int ldp,
                                            const float* x, int ld, int D, int ty, int tx) {
  for (int c = 0; c < kBlockN; ++c) {
    float pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty * 4 + i) * ldp + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      const float xv = d < D ? x[c * ld + d] : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], xv, acc[i][j]);
    }
  }
}

// Writes a (64, D) fp32 tile staged in shared memory (stride ld) to rows
// n0.. of a head of the gradient (row stride row_stride), applying the
// transposed RoPE x*cos + roll(x*sin', D/2) in fp32 when rotate is set.
template <typename T, int NTHREADS>
__device__ void store_rows(T* out_base, long long row_stride, const float* tile, int ld, int n0,
                           int N, int D, bool rotate, const float* cos_t, const float* sin_t) {
  const int half = D / 2;
  for (int idx = threadIdx.x; idx < kBlockM * D; idx += NTHREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int n = n0 + r;
    if (n >= N) continue;
    float val = tile[r * ld + d];
    if (rotate) {
      const int p = rope_partner(d, half);
      val = val * cos_t[n * D + d] + tile[r * ld + p] * sin_t[n * D + p];
    }
    out_base[n * row_stride + d] = from_float<T>(val);
  }
}

// pass 1, fp32: dq and the row statistics for 64 queries
template <int NJ>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq_kernel(View q, View k, View v, View g, View dq, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, float* __restrict__ stats, int B, int N,
                   int H, int D, float scale, int use_rope) {
  extern __shared__ float smem[];
  const int ld = D + 1;  // odd row stride: column reads hit distinct banks
  const int ldp = kBlockN + 1;
  float* q_s = smem;                  // kBlockM x ld (reused for dq at the end)
  float* g_s = q_s + kBlockM * ld;    // kBlockM x ld
  float* k_s = g_s + kBlockM * ld;    // kBlockN x ld
  float* v_s = k_s + kBlockN * ld;    // kBlockN x ld
  float* p_s = v_s + kBlockN * ld;    // kBlockM x ldp: scores, then dS
  float* dp_s = p_s + kBlockM * ldp;  // kBlockM x ldp: dP
  float* m_s = dp_s + kBlockM * ldp;  // row max
  float* l_s = m_s + kBlockM;         // row sum, then its inverse
  float* d_s = l_s + kBlockM;         // sum of exp(s - m) * dP, then delta

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* __restrict__ qb = head_base<const float>(q, b, h);
  const float* __restrict__ kb = head_base<const float>(k, b, h);
  const float* __restrict__ vb = head_base<const float>(v, b, h);
  const float* __restrict__ gb = head_base<const float>(g, b, h);
  const bool rope = use_rope != 0;

  load_tile_f32(q_s, ld, qb, q.sn, q0, N, D, rope, cos_t, sin_t);
  load_tile_f32(g_s, ld, gb, g.sn, q0, N, D, false, cos_t, sin_t);
  if (tid < kBlockM) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    d_s[tid] = 0.f;
  }

  // stream 1: online row max, row sum and sum of exp(s - m) * dP
  for (int k0 = 0; k0 < N; k0 += kBlockN) {
    __syncthreads();
    load_tile_f32(k_s, ld, kb, k.sn, k0, N, D, rope, cos_t, sin_t);
    load_tile_f32(v_s, ld, vb, v.sn, k0, N, D, false, cos_t, sin_t);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot_f32(s, q_s, k_s, ld, D, ty, tx);
    tile_dot_f32(dp, g_s, v_s, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        p_s[(ty * 4 + i) * ldp + c] = (k0 + c < N) ? s[i][j] * scale : -INFINITY;
        dp_s[(ty * 4 + i) * ldp + c] = dp[i][j];
      }
    __syncthreads();
    {
      const int r = tid >> 2;  // four neighbouring lanes share one row
      const int part = tid & 3;
      const float* prow = p_s + r * ldp;
      const float* dprow = dp_s + r * ldp;
      float mx = -INFINITY;
      for (int c = part; c < kBlockN; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a key < N
      float sum = 0.f, dsum = 0.f;
      for (int c = part; c < kBlockN; c += 4) {
        const float e = expf(prow[c] - m_new);
        sum += e;
        dsum += e * dprow[c];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
      dsum += __shfl_xor_sync(0xffffffffu, dsum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        d_s[r] = d_s[r] * alpha + dsum;
      }
    }
  }
  __syncthreads();
  if (tid < kBlockM) {
    const float il = 1.0f / l_s[tid];
    const float delta = d_s[tid] * il;
    const int n = q0 + tid;
    if (n < N) {
      const long long at = ((long long)b * H + h) * N + n;
      const long long plane = (long long)B * H * N;
      stats[at] = m_s[tid];
      stats[plane + at] = l_s[tid];
      stats[2 * plane + at] = delta;
    }
    l_s[tid] = il;
    d_s[tid] = delta;
  }

  // stream 2: dS and dq = dS . K~
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kBlockN) {
    __syncthreads();
    load_tile_f32(k_s, ld, kb, k.sn, k0, N, D, rope, cos_t, sin_t);
    load_tile_f32(v_s, ld, vb, v.sn, k0, N, D, false, cos_t, sin_t);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot_f32(s, q_s, k_s, ld, D, ty, tx);
    tile_dot_f32(dp, g_s, v_s, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const float m = m_s[r], il = l_s[r], delta = d_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float p = expf(s[i][j] * scale - m) * il;
        p_s[r * ldp + c] = (k0 + c < N) ? p * (dp[i][j] - delta) * scale : 0.f;
      }
    }
    __syncthreads();
    tile_pv_f32<NJ>(acc, p_s, ldp, k_s, ld, D, ty, tx);
  }

  __syncthreads();  // every reader of q_s is done: stage dq there
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) q_s[(ty * 4 + i) * ld + d] = acc[i][j];
    }
  __syncthreads();
  store_rows<float, kThreads>(head_base<float>(dq, b, h), dq.sn, q_s, ld, q0, N, D, rope, cos_t,
                              sin_t);
}

// pass 2, fp32: dk and dv for 64 keys
template <int NJ>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv_kernel(View q, View k, View v, View g, View dk, View dv,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                     const float* __restrict__ stats, int B, int N, int H, int D, float scale,
                     int use_rope) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  const int ldp = kBlockN + 1;
  float* k_s = smem;                  // kBlockM x ld, resident
  float* v_s = k_s + kBlockM * ld;    // kBlockM x ld, resident
  float* q_s = v_s + kBlockM * ld;    // kBlockN x ld (reused for dk at the end)
  float* g_s = q_s + kBlockN * ld;    // kBlockN x ld
  float* p_s = g_s + kBlockN * ld;    // kBlockM keys x ldp queries: P^T
  float* ds_s = p_s + kBlockM * ldp;  // kBlockM x ldp: dS^T
  float* m_s = ds_s + kBlockM * ldp;  // the streamed queries' row max,
  float* il_s = m_s + kBlockN;        // inverse row sum
  float* dl_s = il_s + kBlockN;       // and delta

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int k0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* __restrict__ qb = head_base<const float>(q, b, h);
  const float* __restrict__ kb = head_base<const float>(k, b, h);
  const float* __restrict__ vb = head_base<const float>(v, b, h);
  const float* __restrict__ gb = head_base<const float>(g, b, h);
  const long long plane = (long long)B * H * N;
  const float* srow = stats + ((long long)b * H + h) * N;
  const bool rope = use_rope != 0;

  load_tile_f32(k_s, ld, kb, k.sn, k0, N, D, rope, cos_t, sin_t);
  load_tile_f32(v_s, ld, vb, v.sn, k0, N, D, false, cos_t, sin_t);

  float dv_acc[4][NJ], dk_acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dv_acc[i][j] = dk_acc[i][j] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kBlockN) {
    __syncthreads();
    load_tile_f32(q_s, ld, qb, q.sn, q0, N, D, rope, cos_t, sin_t);
    load_tile_f32(g_s, ld, gb, g.sn, q0, N, D, false, cos_t, sin_t);
    if (tid < kBlockN) {
      const int n = q0 + tid;
      const bool in = n < N;
      m_s[tid] = in ? srow[n] : 0.f;
      il_s[tid] = in ? 1.0f / srow[plane + n] : 0.f;
      dl_s[tid] = in ? srow[2 * plane + n] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];  // keys ty*4+i, queries tx+16j
    tile_dot_f32(st, k_s, q_s, ld, D, ty, tx);
    tile_dot_f32(dpt, v_s, g_s, ld, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool in = q0 + c < N;
        const float p = in ? expf(st[i][j] * scale - m_s[c]) * il_s[c] : 0.f;
        p_s[(ty * 4 + i) * ldp + c] = p;
        ds_s[(ty * 4 + i) * ldp + c] = p * (dpt[i][j] - dl_s[c]) * scale;
      }
    __syncthreads();
    tile_pv_f32<NJ>(dv_acc, p_s, ldp, g_s, ld, D, ty, tx);
    tile_pv_f32<NJ>(dk_acc, ds_s, ldp, q_s, ld, D, ty, tx);
  }

  float* dvb = head_base<float>(dv, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = k0 + ty * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dvb[n * dv.sn + d] = dv_acc[i][j];
    }
  }
  __syncthreads();  // every reader of q_s is done: stage dk there
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) q_s[(ty * 4 + i) * ld + d] = dk_acc[i][j];
    }
  __syncthreads();
  store_rows<float, kThreads>(head_base<float>(dk, b, h), dk.sn, q_s, ld, k0, N, D, rope, cos_t,
                              sin_t);
}

// ---------------------------------------------------------------------------
// bf16 kernels (tensor cores)

// s (16 rows x 64 columns, eight 16x8 tiles) = a . b^T, where a_warp points
// at this lane's A fragment in the warp's 16 rows and b holds 64 rows; both
// are contracted over their DP columns.
template <int DP, int LD>
__device__ __forceinline__ void tile_dot_mma(float (&s)[8][4], const __nv_bfloat16* a_warp,
                                             const __nv_bfloat16* b, int gr, int cq) {
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const __nv_bfloat16* pa = a_warp + ks * 16;
    const uint32_t a[4] = {ld_pair(pa), ld_pair(pa + 8 * LD), ld_pair(pa + 8),
                           ld_pair(pa + 8 * LD + 8)};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const __nv_bfloat16* pb = b + (j * 8 + gr) * LD + ks * 16 + 2 * cq;
      const uint32_t bb[2] = {ld_pair(pb), ld_pair(pb + 8)};
      mma_m16n8k16_bf16(s[j], a, bb);
    }
  }
}

// acc (16 rows x DP) += round(p) . x, where p holds the 16x64 fragments of
// tile_dot_mma and x is a 64-row tile read transposed through ldmatrix
template <int NT, int LD>
__device__ __forceinline__ void tile_pv_mma(float (&acc)[NT][4], const float (&p)[8][4],
                                            const __nv_bfloat16* x, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                           pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                           pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                           pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const __nv_bfloat16* rows = x + (kk * 16 + lane % 16) * LD;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      uint32_t bb[2];
      ldmatrix_x2_trans(bb[0], bb[1], rows + t * 8);
      mma_m16n8k16_bf16(acc[t], a, bb);
    }
  }
}

// stage a warp's (16, DP) fp32 accumulator into a (64, DP) fp32 tile
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

// pass 1, bf16: dq and the row statistics for 64 queries
template <int DP, int VEC>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dq_mma_kernel(View q, View k, View v, View g, View dq, const float* __restrict__ cos_t,
                       const float* __restrict__ sin_t, float* __restrict__ stats, int B, int N,
                       int H, int D, float scale, int use_rope) {
  constexpr int LD = DP + 8;  // row stride (bf16): conflict-free fragments
  constexpr int NT = DP / 8;  // 8-column tiles of dq
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* g_s = q_s + kBlockM * LD;
  __nv_bfloat16* k_s = g_s + kBlockM * LD;
  __nv_bfloat16* v_s = k_s + kBlockN * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row group
  const int cq = lane % 4;  // fragment column pair
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  using T = __nv_bfloat16;
  const T* __restrict__ qb = head_base<const T>(q, b, h);
  const T* __restrict__ kb = head_base<const T>(k, b, h);
  const T* __restrict__ vb = head_base<const T>(v, b, h);
  const T* __restrict__ gb = head_base<const T>(g, b, h);
  const bool rope = use_rope != 0;

  load_tile_bf16<DP, LD, VEC>(q_s, qb, q.sn, q0, N, D);
  load_tile_bf16<DP, LD, VEC>(g_s, gb, g.sn, q0, N, D);
  if (rope) {
    __syncthreads();
    rotate_tile_bf16<LD>(q_s, q0, N, D, cos_t, sin_t);
  }
  const __nv_bfloat16* q_warp = q_s + (warp * 16 + gr) * LD + 2 * cq;
  const __nv_bfloat16* g_warp = g_s + (warp * 16 + gr) * LD + 2 * cq;

  // stream 1: online row max, row sum and sum of exp(s - m) * dP, for the
  // lane's rows gr and gr + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, e0 = 0.f, e1 = 0.f;
  for (int k0 = 0; k0 < N; k0 += kBlockN) {
    __syncthreads();  // the previous tile's readers are done with k_s, v_s
    load_tile_bf16<DP, LD, VEC>(k_s, kb, k.sn, k0, N, D);
    load_tile_bf16<DP, LD, VEC>(v_s, vb, v.sn, k0, N, D);
    if (rope) {
      __syncthreads();
      rotate_tile_bf16<LD>(k_s, k0, N, D, cos_t, sin_t);
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    tile_dot_mma<DP, LD>(s, q_warp, k_s, gr, cq);
    tile_dot_mma<DP, LD>(dp, g_warp, v_s, gr, cq);
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
  const float il0 = 1.0f / l0, il1 = 1.0f / l1;
  const float delta0 = e0 * il0, delta1 = e1 * il1;

  // stream 2: dS and dq = dS . K~
  float dq_acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) dq_acc[t][0] = dq_acc[t][1] = dq_acc[t][2] = dq_acc[t][3] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kBlockN) {
    __syncthreads();
    load_tile_bf16<DP, LD, VEC>(k_s, kb, k.sn, k0, N, D);
    load_tile_bf16<DP, LD, VEC>(v_s, vb, v.sn, k0, N, D);
    if (rope) {
      __syncthreads();
      rotate_tile_bf16<LD>(k_s, k0, N, D, cos_t, sin_t);
    }
    __syncthreads();
    float s[8][4], dp[8][4];
    tile_dot_mma<DP, LD>(s, q_warp, k_s, gr, cq);
    tile_dot_mma<DP, LD>(dp, g_warp, v_s, gr, cq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + j * 8 + 2 * cq + (e & 1) < N;
        const float m = e < 2 ? m0 : m1;
        const float il = e < 2 ? il0 : il1;
        const float delta = e < 2 ? delta0 : delta1;
        const float p = expf(s[j][e] * scale - m) * il;
        s[j][e] = valid ? p * (dp[j][e] - delta) * scale : 0.f;  // dS
      }
    tile_pv_mma<NT, LD>(dq_acc, s, k_s, lane);
  }

  // row statistics for pass 2; lanes of a quad hold the same values
  const int r0 = q0 + warp * 16 + gr;
  if (cq == 0) {
    const long long plane = (long long)B * H * N;
    float* srow = stats + ((long long)b * H + h) * N;
    if (r0 < N) {
      srow[r0] = m0;
      srow[plane + r0] = l0;
      srow[2 * plane + r0] = delta0;
    }
    if (r0 + 8 < N) {
      srow[r0 + 8] = m1;
      srow[plane + r0 + 8] = l1;
      srow[2 * plane + r0 + 8] = delta1;
    }
  }
  __syncthreads();  // every reader of q_s, g_s is done: stage dq there in fp32
  float* dq_s = reinterpret_cast<float*>(mma_smem);  // 64 x DP floats fit q_s + g_s
  stage_acc<NT, DP>(dq_s, dq_acc, warp, gr, cq);
  __syncthreads();
  store_rows<T, kMmaThreads>(head_base<T>(dq, b, h), dq.sn, dq_s, DP, q0, N, D, rope, cos_t,
                             sin_t);
}

// pass 2, bf16: dk and dv for 64 keys
template <int DP, int VEC>
__global__ void __launch_bounds__(kMmaThreads)
attn_bwd_dkdv_mma_kernel(View q, View k, View v, View g, View dk, View dv,
                         const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                         const float* __restrict__ stats, int B, int N, int H, int D,
                         float scale, int use_rope) {
  constexpr int LD = DP + 8;
  constexpr int NT = DP / 8;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* v_s = k_s + kBlockM * LD;
  __nv_bfloat16* q_s = v_s + kBlockM * LD;
  __nv_bfloat16* g_s = q_s + kBlockN * LD;
  float* m_s = reinterpret_cast<float*>(g_s + kBlockN * LD);  // the streamed queries'
  float* il_s = m_s + kBlockN;                                // row max, inverse row
  float* dl_s = il_s + kBlockN;                               // sum and delta

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int cq = lane % 4;
  const int k0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  using T = __nv_bfloat16;
  const T* __restrict__ qb = head_base<const T>(q, b, h);
  const T* __restrict__ kb = head_base<const T>(k, b, h);
  const T* __restrict__ vb = head_base<const T>(v, b, h);
  const T* __restrict__ gb = head_base<const T>(g, b, h);
  const long long plane = (long long)B * H * N;
  const float* srow = stats + ((long long)b * H + h) * N;
  const bool rope = use_rope != 0;

  load_tile_bf16<DP, LD, VEC>(k_s, kb, k.sn, k0, N, D);
  load_tile_bf16<DP, LD, VEC>(v_s, vb, v.sn, k0, N, D);
  if (rope) {
    __syncthreads();
    rotate_tile_bf16<LD>(k_s, k0, N, D, cos_t, sin_t);
  }
  const __nv_bfloat16* k_warp = k_s + (warp * 16 + gr) * LD + 2 * cq;
  const __nv_bfloat16* v_warp = v_s + (warp * 16 + gr) * LD + 2 * cq;

  float dv_acc[NT][4], dk_acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv_acc[t][e] = dk_acc[t][e] = 0.f;

  for (int q0 = 0; q0 < N; q0 += kBlockN) {
    __syncthreads();  // the previous tile's readers are done with q_s, g_s
    load_tile_bf16<DP, LD, VEC>(q_s, qb, q.sn, q0, N, D);
    load_tile_bf16<DP, LD, VEC>(g_s, gb, g.sn, q0, N, D);
    if (threadIdx.x < kBlockN) {
      const int n = q0 + threadIdx.x;
      const bool in = n < N;
      m_s[threadIdx.x] = in ? srow[n] : 0.f;
      il_s[threadIdx.x] = in ? 1.0f / srow[plane + n] : 0.f;
      dl_s[threadIdx.x] = in ? srow[2 * plane + n] : 0.f;
    }
    if (rope) {
      __syncthreads();
      rotate_tile_bf16<LD>(q_s, q0, N, D, cos_t, sin_t);
    }
    __syncthreads();
    // P^T and dP^T: this warp's 16 keys x the tile's 64 queries
    float pt[8][4], dpt[8][4];
    tile_dot_mma<DP, LD>(pt, k_warp, q_s, gr, cq);
    tile_dot_mma<DP, LD>(dpt, v_warp, g_s, gr, cq);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * cq + (e & 1);
        const float p = q0 + c < N ? expf(pt[j][e] * scale - m_s[c]) * il_s[c] : 0.f;
        pt[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dl_s[c]) * scale;  // dS^T
      }
    tile_pv_mma<NT, LD>(dv_acc, pt, g_s, lane);
    tile_pv_mma<NT, LD>(dk_acc, dpt, q_s, lane);
  }

  T* dvb = head_base<T>(dv, b, h);
  const int r0 = k0 + warp * 16 + gr;
#pragma unroll
  for (int half_row = 0; half_row < 2; ++half_row) {
    const int n = r0 + 8 * half_row;
    if (n >= N) continue;
    __nv_bfloat16* dst = dvb + n * dv.sn;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = t * 8 + 2 * cq;  // even, and D is even: d < D covers d + 1
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + d) =
            __floats2bfloat162_rn(dv_acc[t][2 * half_row], dv_acc[t][2 * half_row + 1]);
    }
  }
  __syncthreads();  // every reader of q_s, g_s is done: stage dk there in fp32
  float* dk_s = reinterpret_cast<float*>(q_s);  // 64 x DP floats fit q_s + g_s
  stage_acc<NT, DP>(dk_s, dk_acc, warp, gr, cq);
  __syncthreads();
  store_rows<T, kMmaThreads>(head_base<T>(dk, b, h), dk.sn, dk_s, DP, k0, N, D, rope, cos_t,
                             sin_t);
}

// ---------------------------------------------------------------------------
// launches

// q, k, v, g: inputs; dq, dk, dv: outputs with 4-byte aligned rows (the
// wrappers allocate them), each written whole; cos, sin: (N, D) fp32 tables
// (sin sign-folded), read only when use_rope; stats: (3, B, H, N) fp32 scratch.
struct BwdArgs {
  View q, k, v, g, dq, dk, dv;
  const float* cos_t;
  const float* sin_t;
  float* stats;
  int B, N, H, D, use_rope;
  cudaStream_t stream;
};

template <int DP, int VEC>
cudaError_t launch_bwd_mma(const BwdArgs& a) {
  using T = __nv_bfloat16;
  const size_t smem1 = sizeof(T) * 4 * kBlockM * (DP + 8);
  const size_t smem2 = smem1 + sizeof(float) * 3 * kBlockN;
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_mma_kernel<DP, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_mma_kernel<DP, VEC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kBlockM - 1) / kBlockM, a.H, a.B);
  const float scale = 1.0f / sqrtf((float)a.D);
  attn_bwd_dq_mma_kernel<DP, VEC><<<grid, kMmaThreads, smem1, a.stream>>>(
      a.q, a.k, a.v, a.g, a.dq, a.cos_t, a.sin_t, a.stats, a.B, a.N, a.H, a.D, scale,
      a.use_rope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_mma_kernel<DP, VEC><<<grid, kMmaThreads, smem2, a.stream>>>(
      a.q, a.k, a.v, a.g, a.dk, a.dv, a.cos_t, a.sin_t, a.stats, a.B, a.N, a.H, a.D, scale,
      a.use_rope);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch_bwd_mma_dp(const BwdArgs& a) {
  if (a.D <= 32) return launch_bwd_mma<32, VEC>(a);
  if (a.D <= 64) return launch_bwd_mma<64, VEC>(a);
  if (a.D <= 80) return launch_bwd_mma<80, VEC>(a);
  return launch_bwd_mma<128, VEC>(a);
}

template <int NJ>
cudaError_t launch_bwd_f32(const BwdArgs& a) {
  const int ld = a.D + 1;
  const size_t smem = sizeof(float) * ((size_t)4 * kBlockM * ld + (size_t)2 * kBlockM * (kBlockN + 1) +
                                       3 * kBlockM);
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<NJ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kBlockM - 1) / kBlockM, a.H, a.B);
  const float scale = 1.0f / sqrtf((float)a.D);
  attn_bwd_dq_kernel<NJ><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.g, a.dq, a.cos_t, a.sin_t, a.stats, a.B, a.N, a.H, a.D, scale,
      a.use_rope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  attn_bwd_dkdv_kernel<NJ><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.g, a.dk, a.dv, a.cos_t, a.sin_t, a.stats, a.B, a.N, a.H, a.D, scale,
      a.use_rope);
  return cudaGetLastError();
}

// dtype: 0 = float32 (FMA kernels), 1 = bfloat16 (tensor-core kernels).
// Needs B, N, H >= 1 and an even D <= 128.
cudaError_t attention_bwd(const BwdArgs& a, int dtype) {
  if (a.B < 1 || a.N < 1 || a.H < 1 || a.D < 2 || a.D > 128 || (a.D & 1))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    const int nj = (a.D + 15) / 16;
    if (nj <= 4) return launch_bwd_f32<4>(a);
    if (nj <= 5) return launch_bwd_f32<5>(a);
    return launch_bwd_f32<8>(a);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const bool vec8 = rows_aligned16(a.q, a.D) && rows_aligned16(a.k, a.D) &&
                    rows_aligned16(a.v, a.D) && rows_aligned16(a.g, a.D);
  return vec8 ? dispatch_bwd_mma_dp<8>(a) : dispatch_bwd_mma_dp<1>(a);
}

}  // namespace

#endif  // VAVAE_ATTENTION_BWD_CUH
