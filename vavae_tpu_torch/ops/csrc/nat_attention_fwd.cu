// Fused-qkv attention forward with in-kernel split-half RoPE, for sm_90a.
//
// Replaces vavae_tpu/ops/pallas/flash_attention.py:_nat_fwd_kernel (and the
// two layout transposes around it in fused_qkv_attention). It reads the qkv
// projection output (B, N, 3, H, D) in place, strided, and writes
// (B, N, H, D) directly: the TPU's (B, 3, H, N, D) copy does not exist here.
//
// Numerics follow the TPU kernel:
//   q~ = q*cos + roll(q, D/2)*sin'   in the input dtype (sin' sign-folded)
//   s  = (q~ . k~^T) * D^-0.5       fp32 accumulation
//   p  = exp(s - rowmax)            fp32, rounded to the input dtype for P.V
//   o  = (P . V) / rowsum(p)        fp32 accumulation, division last
// The softmax is one-pass online over 64-key tiles (running max and sum in
// fp32), which equals the full softmax of the TPU kernel to rounding.
//
// Bound on an H100 SXM at the main-path shape (B=16, H=16, N=256, D=72,
// bf16): 4*B*H*N^2*D = 4.83 GFLOP -> 4.9 us at 989 TFLOP/s, against
// (3 + 1)*B*N*H*D*2 = 37.7 MB of input and output -> 11.3 us at 3.35 TB/s,
// so the bound is the bytes.
//
// Design. Each block owns one (batch, head, 64-query) tile and streams K/V
// tiles of 64 keys through shared memory; nothing but the output leaves the
// block, so the (N, N) scores never reach device memory.
//  - bf16 (the sampling path): four warps, 16 query rows each, run both
//    products on the tensor cores with mma.sync m16n8k16 (bf16 in, fp32
//    accumulate); the head dim is zero-padded to a multiple of 16 inside
//    shared memory (72 -> 80). Tiles arrive with 16-byte loads; RoPE is
//    applied in shared memory, one (d, d + D/2) pair per item. The scores
//    stay in registers: the fp32 accumulator of Q.K^T is rounded in place
//    into the A operand of P.V, whose V operand comes through ldmatrix.trans.
//  - fp32 (tests and checks): 256 threads run both products as fp32 FMAs,
//    4x4 register-blocked.
// What keeps it off the bound: K/V are re-read (and K re-rotated) for every
// 64-query tile, N/64 times per head, loads and compute do not overlap, and
// mma.sync reaches a fraction of the wgmma rate. wgmma/TMA tiles are the
// redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // queries per block
constexpr int kBlockN = 64;   // keys per tile
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// value of x after a round trip through T (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// One 64-row tile of q, k or v (selector w = 0, 1, 2) into shared memory as
// fp32, rows past N zeroed. With rotate, applies the RoPE roll form in the
// input dtype, rounding after each operation as the TPU kernel does.
template <typename T>
__device__ void load_tile(float* dst, int ld, const T* base, long row_stride, long w_offset,
                          int n0, int N, int D, bool rotate, const float* cos_t,
                          const float* sin_t) {
  const int half = D / 2;
  for (int idx = threadIdx.x; idx < kBlockM * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int n = n0 + r;
    float val = 0.f;
    if (n < N) {
      const T* src = base + n * row_stride + w_offset;
      const float x = to_float(src[d]);
      if (rotate) {
        const float xr = to_float(src[d < half ? d + half : d - half]);
        const float c = round_to<T>(cos_t[n * D + d]);
        const float s = round_to<T>(sin_t[n * D + d]);
        val = round_to<T>(round_to<T>(x * c) + round_to<T>(xr * s));
      } else {
        val = x;
      }
    }
    dst[r * ld + d] = val;
  }
}

// NJ = number of 16-column groups of the head dim each thread accumulates.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
nat_fwd_kernel(const T* __restrict__ qkv, const float* __restrict__ cos_t,
               const float* __restrict__ sin_t, T* __restrict__ out, int N, int H, int D,
               float scale, int use_rope) {
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
  const long row_stride = 3L * H * D;  // between tokens of (B, N, 3, H, D)
  const long w_stride = (long)H * D;   // between q, k and v
  const T* base = qkv + (long)b * N * row_stride + (long)h * D;
  const bool rope = use_rope != 0;

  load_tile<T>(q_s, ld, base, row_stride, 0, q0, N, D, rope, cos_t, sin_t);
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
    load_tile<T>(k_s, ld, base, row_stride, w_stride, k0, N, D, rope, cos_t, sin_t);
    load_tile<T>(v_s, ld, base, row_stride, 2 * w_stride, k0, N, D, false, cos_t, sin_t);
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
        prow[c] = round_to<T>(p);
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const int n = q0 + r;
    if (n >= N) continue;
    const float l = l_s[r];
    T* dst = out + (((long)b * N + n) * H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) dst[d] = from_float<T>(acc[i][j] / l);
    }
  }
}

constexpr int kMmaThreads = 128;  // 4 warps x 16 query rows

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row-major fragment) * b (16x8, col-major fragment)
__device__ __forceinline__ void mma_m16n8k16_bf16(float (&d)[4], const uint32_t (&a)[4],
                                                  const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// B fragments of two 8x8 bf16 blocks, transposed on the way (ldmatrix):
// lanes 0-7 address the rows of the first block, lanes 8-15 the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

// One 64-row tile of q, k or v (w_offset) into shared memory, row-major with
// stride LD, zero past N and past D. VEC = elements per load: 8 (16 bytes)
// when D % 8 == 0 and the tensor is 16-byte aligned, else 1.
template <int DP, int LD, int VEC>
__device__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* base, long row_stride,
                               long w_offset, int n0, int N, int D) {
  constexpr int kChunks = DP / VEC;
  for (int idx = threadIdx.x; idx < kBlockM * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int d = (idx - r * kChunks) * VEC;
    const int n = n0 + r;
    const bool in = n < N && d < D;
    const __nv_bfloat16* src = base + n * row_stride + w_offset + d;
    if constexpr (VEC == 8) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (in) v = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(dst + r * LD + d) = v;
    } else {
      dst[r * LD + d] = in ? *src : __float2bfloat16(0.f);
    }
  }
}

// Split-half RoPE in place on a tile loaded by load_tile_bf16: each item
// owns the pair (d, d + D/2), so reading the partner before writing is safe.
// Rounds after each operation in bf16, as the TPU kernel does.
template <int LD>
__device__ void rotate_tile_bf16(__nv_bfloat16* buf, int n0, int N, int D, const float* cos_t,
                                 const float* sin_t) {
  const int half = D / 2;
  for (int idx = threadIdx.x; idx < kBlockM * half; idx += kMmaThreads) {
    const int r = idx / half;
    const int d = idx - r * half;
    const int n = n0 + r;
    if (n >= N) continue;
    __nv_bfloat16* row = buf + r * LD;
    const float x = __bfloat162float(row[d]);
    const float xr = __bfloat162float(row[d + half]);
    const float* ct = cos_t + n * D;
    const float* st = sin_t + n * D;
    using T = __nv_bfloat16;
    row[d] = __float2bfloat16(round_to<T>(x * round_to<T>(ct[d])) +
                              round_to<T>(xr * round_to<T>(st[d])));
    row[d + half] = __float2bfloat16(round_to<T>(xr * round_to<T>(ct[d + half])) +
                                     round_to<T>(x * round_to<T>(st[d + half])));
  }
}

// DP = head dim padded to a multiple of 16; VEC as in load_tile_bf16
template <int DP, int VEC>
__global__ void __launch_bounds__(kMmaThreads)
nat_fwd_mma_kernel(const __nv_bfloat16* __restrict__ qkv, const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, __nv_bfloat16* __restrict__ out, int N,
                   int H, int D, float scale, int use_rope) {
  constexpr int LD = DP + 8;  // row stride (bf16) of q_s, k_s, v_s: conflict-free fragments
  constexpr int NT = DP / 8;  // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* k_s = q_s + kBlockM * LD;
  __nv_bfloat16* v_s = k_s + kBlockN * LD;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row group
  const int c = lane % 4;  // fragment column pair
  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const long row_stride = 3L * H * D;
  const long w_stride = (long)H * D;
  const __nv_bfloat16* base = qkv + (long)b * N * row_stride + (long)h * D;
  const bool rope = use_rope != 0;

  load_tile_bf16<DP, LD, VEC>(q_s, base, row_stride, 0, q0, N, D);
  if (rope) {
    __syncthreads();
    rotate_tile_bf16<LD>(q_s, q0, N, D, cos_t, sin_t);
  }

  float o[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // running sums

  const __nv_bfloat16* q_warp = q_s + (warp * 16 + g) * LD + 2 * c;
  for (int k0 = 0; k0 < N; k0 += kBlockN) {
    __syncthreads();  // the previous tile's readers are done with k_s, v_s
    load_tile_bf16<DP, LD, VEC>(k_s, base, row_stride, w_stride, k0, N, D);
    load_tile_bf16<DP, LD, VEC>(v_s, base, row_stride, 2 * w_stride, k0, N, D);
    if (rope) {
      __syncthreads();
      rotate_tile_bf16<LD>(k_s, k0, N, D, cos_t, sin_t);
    }
    __syncthreads();

    // s = q . k^T: 16 rows x 64 keys per warp, eight 16x8 tiles
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const __nv_bfloat16* qa = q_warp + ks * 16;
      const uint32_t a[4] = {ld_pair(qa), ld_pair(qa + 8 * LD), ld_pair(qa + 8),
                             ld_pair(qa + 8 * LD + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kb = k_s + (j * 8 + g) * LD + ks * 16 + 2 * c;
        const uint32_t bb[2] = {ld_pair(kb), ld_pair(kb + 8)};
        mma_m16n8k16_bf16(s[j], a, bb);
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

  const int r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int half_row = 0; half_row < 2; ++half_row) {
    const int n = r0 + 8 * half_row;
    if (n >= N) continue;
    const float l = half_row ? l1 : l0;
    __nv_bfloat16* dst = out + (((long)b * N + n) * H + h) * D;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = t * 8 + 2 * c;  // even, and D is even: d < D covers d + 1
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + d) =
            __floats2bfloat162_rn(o[t][2 * half_row] / l, o[t][2 * half_row + 1] / l);
    }
  }
}

template <int DP, int VEC>
cudaError_t launch_mma(const void* qkv, const float* cos_t, const float* sin_t, void* out,
                       int B, int N, int H, int D, int use_rope, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * 3 * kBlockM * (DP + 8);
  cudaError_t err = cudaFuncSetAttribute(nat_fwd_mma_kernel<DP, VEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockM - 1) / kBlockM, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  nat_fwd_mma_kernel<DP, VEC><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qkv), cos_t, sin_t, static_cast<__nv_bfloat16*>(out),
      N, H, D, scale, use_rope);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t dispatch_mma_dp(const void* qkv, const float* cos_t, const float* sin_t, void* out,
                            int B, int N, int H, int D, int use_rope, cudaStream_t stream) {
  if (D <= 32) return launch_mma<32, VEC>(qkv, cos_t, sin_t, out, B, N, H, D, use_rope, stream);
  if (D <= 64) return launch_mma<64, VEC>(qkv, cos_t, sin_t, out, B, N, H, D, use_rope, stream);
  if (D <= 80) return launch_mma<80, VEC>(qkv, cos_t, sin_t, out, B, N, H, D, use_rope, stream);
  if (D <= 128)
    return launch_mma<128, VEC>(qkv, cos_t, sin_t, out, B, N, H, D, use_rope, stream);
  return launch_mma<256, VEC>(qkv, cos_t, sin_t, out, B, N, H, D, use_rope, stream);
}

cudaError_t dispatch_mma(const void* qkv, const float* cos_t, const float* sin_t, void* out,
                         int B, int N, int H, int D, int use_rope, cudaStream_t stream) {
  const bool vec8 = D % 8 == 0 && reinterpret_cast<uintptr_t>(qkv) % 16 == 0;
  if (vec8) return dispatch_mma_dp<8>(qkv, cos_t, sin_t, out, B, N, H, D, use_rope, stream);
  return dispatch_mma_dp<1>(qkv, cos_t, sin_t, out, B, N, H, D, use_rope, stream);
}

template <typename T, int NJ>
cudaError_t launch(const void* qkv, const float* cos_t, const float* sin_t, void* out, int B,
                   int N, int H, int D, int use_rope, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)3 * kBlockM * (D + 1) + (size_t)kBlockM * (kBlockN + 1) +
                       3 * kBlockM);
  cudaError_t err = cudaFuncSetAttribute(nat_fwd_kernel<T, NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBlockM - 1) / kBlockM, H, B);
  const float scale = 1.0f / sqrtf((float)D);
  nat_fwd_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), cos_t, sin_t, static_cast<T*>(out), N, H, D, scale, use_rope);
  return cudaGetLastError();
}

// fp32: the FMA kernel
template <typename T>
cudaError_t dispatch(const void* qkv, const float* cos_t, const float* sin_t, void* out, int B,
                     int N, int H, int D, int use_rope, cudaStream_t stream) {
  const int nj = (D + 15) / 16;
  if (nj <= 4) return launch<T, 4>(qkv, cos_t, sin_t, out, B, N, H, D, use_rope, stream);
  if (nj <= 5) return launch<T, 5>(qkv, cos_t, sin_t, out, B, N, H, D, use_rope, stream);
  if (nj <= 8) return launch<T, 8>(qkv, cos_t, sin_t, out, B, N, H, D, use_rope, stream);
  return launch<T, 16>(qkv, cos_t, sin_t, out, B, N, H, D, use_rope, stream);
}

}  // namespace

// qkv: (B, N, 3, H, D) contiguous; cos, sin: (N, D) fp32 (sin sign-folded),
// read only when use_rope; out: (B, N, H, D). dtype: 0 = float32, 1 = bfloat16.
// Returns the CUDA error code of the launch (0 on success). Shapes are
// checked by the Python wrapper: N >= 1, even D <= 256.
extern "C" int nat_attention_fwd(const void* qkv, const void* cos_t, const void* sin_t,
                                 void* out, int B, int N, int H, int D, int use_rope,
                                 int dtype, void* stream) {
  if (B < 1 || N < 1 || H < 1 || D < 2 || D > 256 || (D & 1)) return (int)cudaErrorInvalidValue;
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(qkv, c, s, out, B, N, H, D, use_rope, st);
  else if (dtype == 1)
    err = dispatch_mma(qkv, c, s, out, B, N, H, D, use_rope, st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
