// Pieces shared by the attention kernels (attention_fwd.cuh, attention_bwd.cuh):
// strided tensor views, rounding to the input dtype, the mma.sync (bf16 and
// TF32) and ldmatrix wrappers, and the tile loads into shared memory.
//
// Every tensor reaches a kernel as a View: a base pointer and element strides
// over (batch, token, head), the head dim contiguous. The fused-qkv entries
// (nat_attention_*.cu) point q, k and v into one (B, N, 3, H, D) tensor; the
// separate-tensor entries (attn_small_*.cu) pass each tensor's own strides,
// so a strided view such as qkv[:, :, 2] is read in place.

#ifndef VAVAE_ATTENTION_COMMON_CUH
#define VAVAE_ATTENTION_COMMON_CUH

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;       // rows owned by a block
constexpr int kBlockN = 64;       // rows per streamed tile
constexpr int kThreads = 256;     // fp32 kernels: 16 x 16 threads, 4 x 4 outputs each
constexpr int kMmaThreads = 128;  // bf16 kernels: 4 warps x 16 rows

// A (B, N, H, D) tensor: base pointer and element strides; stride 1 over D.
struct View {
  const void* ptr;
  long long sb, sn, sh;
};

// first element of (batch b, token 0, head h)
template <typename T>
__device__ __forceinline__ T* head_base(const View& v, int b, int h) {
  return const_cast<T*>(static_cast<const T*>(v.ptr)) + b * v.sb + h * v.sh;
}

// a contiguous (B, N, H, D) tensor
inline View contiguous_view(const void* ptr, int N, int H, int D) {
  return View{ptr, (long long)N * H * D, (long long)H * D, (long long)D};
}

// 16-byte loads need every row start of the tensor (elements of elem_bytes
// bytes: 2 for bf16, 4 for fp32) on a 16-byte boundary
inline bool rows_aligned16(const View& v, int D, int elem_bytes = 2) {
  const int per = 16 / elem_bytes;
  return D % per == 0 && reinterpret_cast<uintptr_t>(v.ptr) % 16 == 0 && v.sb % per == 0 &&
         v.sn % per == 0 && v.sh % per == 0;
}

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

// the partner of column d in the split-half rotation: roll by D/2
__device__ __forceinline__ int rope_partner(int d, int half) {
  return d < half ? d + half : d - half;
}

// ---------------------------------------------------------------------------
// fp32 kernels

// One 64-row tile (rows n0.. of a head with row stride row_stride) into shared
// memory as fp32 with stride ld, zero past N. With rotate, applies the RoPE
// roll form x*cos + roll(x, D/2)*sin', where sin' is sin_t (kRawSin false:
// the table comes sign-folded) or sin_t negated for d < D/2 (kRawSin true:
// the split-half table as the model holds it; the negation is exact).
template <bool kRawSin = false>
__device__ void load_tile_f32(float* dst, int ld, const float* base, long long row_stride, int n0,
                              int N, int D, bool rotate, const float* cos_t, const float* sin_t) {
  const int half = D / 2;
  for (int idx = threadIdx.x; idx < kBlockM * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int n = n0 + r;
    float val = 0.f;
    if (n < N) {
      const float* src = base + n * row_stride;
      val = src[d];
      if (rotate) {
        const float s = kRawSin && d < half ? -sin_t[n * D + d] : sin_t[n * D + d];
        val = val * cos_t[n * D + d] + src[rope_partner(d, half)] * s;
      }
    }
    dst[r * ld + d] = val;
  }
}

// ---------------------------------------------------------------------------
// bf16 kernels (tensor cores)

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

// x rounded to TF32 (10-bit mantissa, to nearest, ties away from zero), as
// an fp32 bit pattern that the TF32 tensor-core product reads exactly
__device__ __forceinline__ float round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d += a (16x8 TF32, row-major fragment) * b (8x8 TF32, col-major fragment):
// a0 (row g, col c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4);
// b0 (row c, col g), b1 (c + 4, g), for g = lane / 4, c = lane % 4
__device__ __forceinline__ void mma_m16n8k8_tf32(float (&d)[4], const uint32_t (&a)[4],
                                                 const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo for the 3xTF32 products, both as fp32 bit patterns the tensor
// cores read exactly: hi = x rounded to TF32 to nearest, ties away from zero
// (cvt.rna.tf32's rounding, here in two integer operations: the conversion
// unit runs at a quarter of their rate; the same bits for every x but a NaN,
// whose lo stays NaN), lo = the rest x - hi (exact in fp32) by
// cvt.rna.tf32, which leaves at most 2^-22 of |x| out
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(round_tf32(x - __uint_as_float(hi)));
}

// d += a . b at fp32 accuracy on the TF32 tensor cores (3xTF32), a and b as
// split by split_tf32: the correction products lo(a).hi(b) and hi(a).lo(b)
// first, then hi(a).hi(b); lo(a).lo(b), under 2^-22 of |a||b|, is left out
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_m16n8k8_tf32(d, al, bh);
  mma_m16n8k8_tf32(d, ah, bl);
  mma_m16n8k8_tf32(d, ah, bh);
}

// two neighbouring output columns of a row, as T
__device__ __forceinline__ void store_pair(float* dst, float x, float y) {
  dst[0] = x;
  dst[1] = y;
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
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

// One 64-row tile (rows n0.. of a head with row stride row_stride) into
// shared memory, row-major with stride LD, zero past N and past D. VEC =
// elements per load: 8 (16 bytes) when rows_aligned16 holds, else 1.
template <int DP, int LD, int VEC>
__device__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* base, long long row_stride,
                               int n0, int N, int D) {
  constexpr int kChunks = DP / VEC;
  for (int idx = threadIdx.x; idx < kBlockM * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int d = (idx - r * kChunks) * VEC;
    const int n = n0 + r;
    const bool in = n < N && d < D;
    const __nv_bfloat16* src = base + n * row_stride + d;
    if constexpr (VEC == 8) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (in) v = *reinterpret_cast<const uint4*>(src);
      *reinterpret_cast<uint4*>(dst + r * LD + d) = v;
    } else {
      dst[r * LD + d] = in ? *src : __float2bfloat16(0.f);
    }
  }
}

// One 64-row fp32 tile into shared memory as TF32-rounded fp32, row-major
// with stride LD, zero past N and past D. VEC = elements per load: 4 (16
// bytes) when rows_aligned16(., D, 4) holds, else 1.
template <int DP, int LD, int VEC>
__device__ void load_tile_tf32(float* dst, const float* base, long long row_stride, int n0, int N,
                               int D) {
  constexpr int kChunks = DP / VEC;
  for (int idx = threadIdx.x; idx < kBlockM * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks;
    const int d = (idx - r * kChunks) * VEC;
    const int n = n0 + r;
    const bool in = n < N && d < D;
    const float* src = base + n * row_stride + d;
    if constexpr (VEC == 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) v = *reinterpret_cast<const float4*>(src);
      *reinterpret_cast<float4*>(dst + r * LD + d) =
          make_float4(round_tf32(v.x), round_tf32(v.y), round_tf32(v.z), round_tf32(v.w));
    } else {
      dst[r * LD + d] = in ? round_tf32(*src) : 0.f;
    }
  }
}

// Split-half RoPE in place on a tile loaded by load_tile_bf16: each item owns
// the pair (d, d + D/2), so reading the partner before writing is safe.
// Rounds after each operation in bf16, as the TPU kernels do. sin_t is the
// split-half table as the model holds it: its sign is folded here (negated
// for d < D/2, which is exact), so x*cos + rot_half(x)*sin.
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
                              round_to<T>(xr * round_to<T>(-st[d])));
    row[d + half] = __float2bfloat16(round_to<T>(xr * round_to<T>(ct[d + half])) +
                                     round_to<T>(x * round_to<T>(st[d + half])));
  }
}

}  // namespace

#endif  // VAVAE_ATTENTION_COMMON_CUH
