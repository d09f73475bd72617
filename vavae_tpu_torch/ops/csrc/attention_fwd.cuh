// Attention forward with in-kernel split-half RoPE, for sm_90a: the first
// device bodies (mma.sync and fp32 FMA) of nat_attention_fwd.cu (fused qkv)
// and attn_small_fwd.cu (separate q, k, v), which send bf16 calls with D <=
// 128, 16-byte aligned rows and N <= 1024 to attention_fwd_wgmma.cuh and
// fp32 calls with D <= 128 to attention_tf32.cuh instead, and the first
// bodies of flash_fwd.cu (the long route: q, k rotated beforehand, no
// tables). Each reads q, k and v through their Views, in place, and writes a
// contiguous (B, N, H, D) output.
//
// Numerics follow the TPU kernels (_nat_fwd_kernel, _attn_kernel_small_rope,
// _attn_kernel_small, _flash_kernel):
//   q~ = q*cos + roll(q, D/2)*sin'   in the input dtype (sin' = sin negated
//                                    for d < D/2, folded in the kernel:
//                                    q*cos + rot_half(q)*sin)
//   s  = (q~ . k~^T) * D^-0.5       fp32 accumulation
//   p  = exp(s - rowmax)            fp32, rounded to v's dtype for P.V
//   o  = (P . V) / rowsum(p)        fp32 accumulation, division last, in q's dtype
// The softmax is one-pass online over 64-key tiles (running max and sum in
// fp32), which equals the full softmax of the small TPU kernels to rounding
// and is _flash_kernel's own scheme over smaller tiles.
//
// Design. Each block owns one (batch, head, 64-query) tile and streams K/V
// tiles of 64 keys through shared memory; nothing but the output leaves the
// block, so the (N, N) scores never reach device memory.
//  - bf16 (flash_fwd.cu with use_rope: false, and the small route's calls
//    that attention_fwd_wgmma.cuh does not take): four warps, 16 query rows each,
//    run both products on the tensor cores with mma.sync m16n8k16 (bf16 in,
//    fp32 accumulate); the head dim is zero-padded to a multiple of 16 inside
//    shared memory (72 -> 80). Tiles arrive with 16-byte loads when every
//    input's rows are 16-byte aligned, else with scalar loads; RoPE is applied
//    in shared memory, one (d, d + D/2) pair per item. The scores stay in
//    registers: the fp32 accumulator of Q.K^T is rounded in place into the A
//    operand of P.V, whose V operand comes through ldmatrix.trans.
//  - fp32 q, k with bf16 v (flash_fwd.cu on the RoPE models, whose q, k
//    reach it rotated with fp32 tables, hence fp32): the same kernel with
//    q, k held as TF32-rounded fp32 in shared memory and q.k^T on TF32
//    mma.sync m16n8k8 (fp32 accumulate); P.V and the softmax as for bf16;
//    the output in fp32.
//  - fp32 at D in (128, 256] on the small route and flash_fwd.cu's all-fp32
//    pair (fp32 models past N = 1024): 256 threads run both products as fp32
//    FMAs, 4x4 register-blocked. Every other fp32 call takes the 3xTF32 body
//    of attention_tf32.cuh.
// What kept the bf16 kernel at 10x its bound on the small route (bytes): K/V
// re-read (and K re-rotated) for every 64-query tile, N/64 times per head,
// loads and compute that do not overlap, and mma.sync at a fraction of the
// wgmma rate; attention_fwd_wgmma.cuh is the redesign of that route.

#ifndef VAVAE_ATTENTION_FWD_CUH
#define VAVAE_ATTENTION_FWD_CUH

#include "attention_common.cuh"

namespace {

// NJ = number of 16-column groups of the head dim each thread accumulates.
template <int NJ>
__global__ void __launch_bounds__(kThreads)
attn_fwd_kernel(View q, View k, View v, View out, const float* __restrict__ cos_t,
                const float* __restrict__ sin_t, int N, int D, float scale, int use_rope) {
  extern __shared__ float smem[];
  const int ld = D + 1;            // odd row stride: column reads hit distinct banks
  const int ldp = kBlockN + 1;
  float* q_s = smem;               // kBlockM x ld
  float* k_s = q_s + kBlockM * ld; // kBlockN x ld
  float* v_s = k_s + kBlockN * ld; // kBlockN x ld
  float* p_s = v_s + kBlockN * ld; // kBlockM x ldp: scores, then probabilities
  float* m_s = p_s + kBlockM * ldp; // running row max
  float* l_s = m_s + kBlockM;       // running row sum
  float* a_s = l_s + kBlockM;       // per-tile rescale factor

  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* __restrict__ qb = head_base<const float>(q, b, h);
  const float* __restrict__ kb = head_base<const float>(k, b, h);
  const float* __restrict__ vb = head_base<const float>(v, b, h);
  const bool rope = use_rope != 0;

  load_tile_f32<true>(q_s, ld, qb, q.sn, q0, N, D, rope, cos_t, sin_t);
  if (tid < kBlockM) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < N; k0 += kBlockN) {
    __syncthreads();  // the previous tile's readers are done with k_s, v_s, p_s
    load_tile_f32<true>(k_s, ld, kb, k.sn, k0, N, D, rope, cos_t, sin_t);
    load_tile_f32(v_s, ld, vb, v.sn, k0, N, D, false, cos_t, sin_t);
    __syncthreads();

    // scores for rows ty*4+i, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        p_s[(ty * 4 + i) * ldp + c] = (k0 + c < N) ? s[i][j] * scale : -INFINITY;
      }
    __syncthreads();

    // online softmax: four neighbouring lanes share one row
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float* prow = p_s + r * ldp;
      float mx = -INFINITY;
      for (int c = part; c < kBlockN; c += 4) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile holds a key < N
      float sum = 0.f;
      for (int c = part; c < kBlockN; c += 4) {
        const float p = expf(prow[c] - m_new);
        sum += p;
        prow[c] = p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V for rows ty*4+i, head columns tx+16*j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    for (int c = 0; c < kBlockN; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * ldp + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < D ? v_s[c * ld + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  // l_s holds the final sums: the last softmax was followed by a barrier
  float* ob = head_base<float>(out, b, h);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int n = q0 + r;
    if (n >= N) continue;
    const float l = l_s[r];
    float* dst = ob + n * out.sn;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dst[d] = acc[i][j] / l;
    }
  }
}

// TQK = dtype of q, k and the output: __nv_bfloat16 (q.k^T on bf16
// m16n8k16, optional RoPE) or float (q.k^T on TF32 m16n8k8 over
// TF32-rounded q, k; no RoPE; the fp32 output of flash_fwd.cu). v is bf16
// either way. DP = head dim padded to a multiple of 16; VEC as in
// load_tile_bf16 (8: every input's rows are 16-byte aligned).
template <typename TQK, int DP, int VEC>
__global__ void __launch_bounds__(kMmaThreads)
attn_fwd_mma_kernel(View q, View k, View v, View out, const float* __restrict__ cos_t,
                    const float* __restrict__ sin_t, int N, int D, float scale, int use_rope) {
  constexpr bool kTf32 = sizeof(TQK) == 4;
  constexpr int LD = DP + 8;  // row stride (bf16) of v_s (and q_s, k_s): conflict-free fragments
  // row stride of q_s, k_s: fp32 rows of DP + 4 put the eight fragment rows
  // of a TF32 load on distinct bank quads
  constexpr int LDQ = kTf32 ? DP + 4 : LD;
  constexpr int NT = DP / 8;  // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char mma_smem[];
  TQK* q_s = reinterpret_cast<TQK*>(mma_smem);
  TQK* k_s = q_s + kBlockM * LDQ;
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(k_s + kBlockN * LDQ);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int c = lane % 4;  // fragment column pair
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  using T = __nv_bfloat16;
  const TQK* __restrict__ qb = head_base<const TQK>(q, b, h);
  const TQK* __restrict__ kb = head_base<const TQK>(k, b, h);
  const T* __restrict__ vb = head_base<const T>(v, b, h);
  const bool rope = !kTf32 && use_rope != 0;

  if constexpr (kTf32) {
    load_tile_tf32<DP, LDQ, VEC == 8 ? 4 : 1>(q_s, qb, q.sn, q0, N, D);
  } else {
    load_tile_bf16<DP, LD, VEC>(q_s, qb, q.sn, q0, N, D);
    if (rope) {
      __syncthreads();
      rotate_tile_bf16<LD>(q_s, q0, N, D, cos_t, sin_t);
    }
  }

  float o[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // running sums

  // this lane's first A-fragment element: row g, column c (TF32) or the
  // column pair 2c (bf16)
  const TQK* q_warp = q_s + (warp * 16 + g) * LDQ + (kTf32 ? c : 2 * c);
  for (int k0 = 0; k0 < N; k0 += kBlockN) {
    __syncthreads();  // the previous tile's readers are done with k_s, v_s
    if constexpr (kTf32) {
      load_tile_tf32<DP, LDQ, VEC == 8 ? 4 : 1>(k_s, kb, k.sn, k0, N, D);
    } else {
      load_tile_bf16<DP, LD, VEC>(k_s, kb, k.sn, k0, N, D);
    }
    load_tile_bf16<DP, LD, VEC>(v_s, vb, v.sn, k0, N, D);
    if constexpr (!kTf32) {
      if (rope) {
        __syncthreads();
        rotate_tile_bf16<LD>(k_s, k0, N, D, cos_t, sin_t);
      }
    }
    __syncthreads();

    // s = q . k^T: 16 rows x 64 keys per warp, eight 16x8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (kTf32) {
#pragma unroll
      for (int ks = 0; ks < DP / 8; ++ks) {
        const float* qa = q_warp + ks * 8;
        const uint32_t a[4] = {__float_as_uint(qa[0]), __float_as_uint(qa[8 * LDQ]),
                               __float_as_uint(qa[4]), __float_as_uint(qa[8 * LDQ + 4])};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* kt = k_s + (j * 8 + g) * LDQ + ks * 8 + c;
          const uint32_t bb[2] = {__float_as_uint(kt[0]), __float_as_uint(kt[4])};
          mma_m16n8k8_tf32(s[j], a, bb);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const T* qa = q_warp + ks * 16;
        const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * LD), ld_pair(qa + 8),
                               ld_pair(qa + 8 * LD + 8)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const T* kt = k_s + (j * 8 + g) * LD + ks * 16 + 2 * c;
          const uint32_t bb[2] = {ld_pair(kt), ld_pair(kt + 8)};
          mma_m16n8k16_bf16(s[j], a, bb);
        }
      }
    }

    // scale, mask keys past N, online softmax over the four lanes of a row
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = k0 + j * 8 + 2 * c + (e & 1) < N;
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
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float alpha0 = expf(m0 - mn0);
    const float alpha1 = expf(m1 - mn1);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      o[t][0] *= alpha0;
      o[t][1] *= alpha0;
      o[t][2] *= alpha1;
      o[t][3] *= alpha1;
    }

    // o += P . V: the score tiles 2kk, 2kk+1 are the A fragment of keys
    // 16kk..16kk+15, rounded to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* v_rows = v_s + (kk * 16 + lane % 16) * LD;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t bb[2];
        ldmatrix_x2_trans(bb[0], bb[1], v_rows + t * 8);
        mma_m16n8k16_bf16(o[t], a, bb);
      }
    }
  }

  TQK* ob = head_base<TQK>(out, b, h);
  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int half_row = 0; half_row < 2; ++half_row) {
    const int n = r0 + 8 * half_row;
    if (n >= N) continue;
    const float l = half_row ? l1 : l0;
    TQK* dst = ob + n * out.sn;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = t * 8 + 2 * c;  // even, and D is even: d < D covers d + 1
      if (d < D) store_pair(dst + d, o[t][2 * half_row] / l, o[t][2 * half_row + 1] / l);
    }
  }
}

// q, k, v: inputs; out: a (B, N, H, D) output with 4-byte aligned rows (the
// wrappers allocate it contiguous); cos, sin: (N, D) fp32 split-half tables
// as the model holds them (the kernels fold the sign of sin), read only when
// use_rope (never by the TF32 kernel).
struct FwdArgs {
  View q, k, v, out;
  const float* cos_t;
  const float* sin_t;
  int B, N, H, D, use_rope;
  cudaStream_t stream;
};

template <typename TQK, int DP, int VEC>
cudaError_t launch_fwd_mma(const FwdArgs& a) {
  constexpr int LDQ = sizeof(TQK) == 4 ? DP + 4 : DP + 8;  // as in the kernel
  const size_t smem = sizeof(TQK) * 2 * kBlockM * LDQ + sizeof(__nv_bfloat16) * kBlockN * (DP + 8);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_mma_kernel<TQK, DP, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + kBlockM - 1) / kBlockM, a.H, a.B);
  const float scale = 1.0f / sqrtf((float)a.D);
  attn_fwd_mma_kernel<TQK, DP, VEC><<<grid, kMmaThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.out, a.cos_t, a.sin_t, a.N, a.D, scale, a.use_rope);
  return cudaGetLastError();
}

template <typename TQK, int VEC>
cudaError_t dispatch_fwd_mma_dp(const FwdArgs& a) {
  if (a.D <= 32) return launch_fwd_mma<TQK, 32, VEC>(a);
  if (a.D <= 64) return launch_fwd_mma<TQK, 64, VEC>(a);
  if (a.D <= 80) return launch_fwd_mma<TQK, 80, VEC>(a);
  if (a.D <= 128) return launch_fwd_mma<TQK, 128, VEC>(a);
  return launch_fwd_mma<TQK, 256, VEC>(a);
}

// shared memory of the FMA kernel at head dim D
inline size_t fwd_f32_smem(int D) {
  return sizeof(float) *
         ((size_t)3 * kBlockM * (D + 1) + (size_t)kBlockM * (kBlockN + 1) + 3 * kBlockM);
}

template <int NJ>
cudaError_t launch_fwd_f32(const FwdArgs& a) {
  // once per instance (the process runs on one card): the shared memory
  // allowance of the widest head dim the instance takes, 16 * NJ
  static const cudaError_t setup = cudaFuncSetAttribute(
      attn_fwd_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fwd_f32_smem(16 * NJ));
  if (setup != cudaSuccess) return setup;
  const size_t smem = fwd_f32_smem(a.D);
  const dim3 grid((a.N + kBlockM - 1) / kBlockM, a.H, a.B);
  const float scale = 1.0f / sqrtf((float)a.D);
  attn_fwd_kernel<NJ><<<grid, kThreads, smem, a.stream>>>(
      a.q, a.k, a.v, a.out, a.cos_t, a.sin_t, a.N, a.D, scale, a.use_rope);
  return cudaGetLastError();
}

inline bool valid_shape(const FwdArgs& a) {
  return a.B >= 1 && a.N >= 1 && a.H >= 1 && a.D >= 2 && a.D <= 256 && !(a.D & 1);
}

// The first bodies: dtype 0 = float32 (FMA kernel: the calls the 3xTF32
// body does not take), 1 = bfloat16 (mma.sync kernel). Needs B, N, H >= 1 and
// an even D <= 256.
cudaError_t attention_fwd_mma_sync(const FwdArgs& a, int dtype) {
  if (!valid_shape(a)) return cudaErrorInvalidValue;
  if (dtype == 0) {
    const int nj = (a.D + 15) / 16;
    if (nj <= 4) return launch_fwd_f32<4>(a);
    if (nj <= 5) return launch_fwd_f32<5>(a);
    if (nj <= 8) return launch_fwd_f32<8>(a);
    return launch_fwd_f32<16>(a);
  }
  if (dtype != 1) return cudaErrorInvalidValue;
  const bool vec8 =
      rows_aligned16(a.q, a.D) && rows_aligned16(a.k, a.D) && rows_aligned16(a.v, a.D);
  using T = __nv_bfloat16;
  return vec8 ? dispatch_fwd_mma_dp<T, 8>(a) : dispatch_fwd_mma_dp<T, 1>(a);
}

}  // namespace

#endif  // VAVAE_ATTENTION_FWD_CUH
