// Long-sequence attention forward on q~, k~ rotated beforehand, for sm_90a.
//
// Replaces vavae_tpu/ops/pallas/flash_attention.py:_flash_kernel, which
// _forward launches for N > 1024 (SMALL_SEQ_MAX) after applying RoPE outside
// the kernel with fp32 tables, and the padding and layout copies around it:
// the TPU pads the head dim to 128 and folds (B, H) into (B*H, N, 128). Here
// q~, k~ and v are read in place through their own batch, token and head
// strides (v is the strided view qkv[:, :, 2]) and the output is written as
// (B, N, H, D) in q~'s dtype. Any N >= 1: keys past N in the last tile are
// masked, where the JAX package sends an N that is not a multiple of 256 to
// _xla_attention. The device bodies:
//   q~, k~ fp32 or bf16 with bf16 v, D % 8 == 0, D <= 72, 16-byte aligned
//        rows (the RoPE models and use_rope: false at D = 72 or 64):
//        flash_fwd_wgmma.cuh, TF32 (or bf16) wgmma for q~.k~^T, bf16 wgmma
//        for P.V, the redesign for Hopper;
//   other fp32 q~, k~ with bf16 v (misaligned views, other D): the TF32
//        mma.sync body of attention_fwd.cuh;
//   other bf16 calls: its bf16 mma.sync body; all fp32 (fp32 models): its
//        fp32 FMA body.
//
// Bound on an H100 SXM at the main-path shape (B=4, H=16, N=4096, D=72, q~,
// k~ fp32, v bf16, out fp32): 4*B*H*N^2*D = 309 GFLOP -> 0.313 ms at 989
// TFLOP/s (bf16), 0.469 ms if q~.k~^T, half the work, runs at TF32's 495,
// against (4 + 4 + 2 + 4)*B*N*H*D = 264 MB of input and output -> 0.079 ms
// at 3.35 TB/s, so the bound is the operations; flash_fwd_wgmma.cuh's note
// says what its design does about it.

#include "flash_fwd_wgmma.cuh"

namespace {

// fp32 q~, k~ with bf16 v: the TF32 kernel
cudaError_t attention_fwd_tf32(const FwdArgs& a) {
  if (!valid_shape(a) || a.use_rope) return cudaErrorInvalidValue;
  const bool vec = rows_aligned16(a.q, a.D, 4) && rows_aligned16(a.k, a.D, 4) &&
                   rows_aligned16(a.v, a.D);
  return vec ? dispatch_fwd_mma_dp<float, 8>(a) : dispatch_fwd_mma_dp<float, 1>(a);
}

}  // namespace

// q, k, v: (B, N, H, D) with element strides strides[3*i .. 3*i + 2] =
// (batch, token, head) for i = q, k, v, and stride 1 over D; out: (B, N, H, D)
// contiguous in qk_dtype. qk_dtype (q and k), v_dtype: 0 = float32,
// 1 = bfloat16; the pairs (0, 1), (1, 1) and (0, 0) are taken. Returns the
// CUDA error code of the launch (0 on success). Shapes are checked by the
// Python wrapper: N >= 1, even D <= 256.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* out,
                         const long long* strides, int B, int N, int H, int D, int qk_dtype,
                         int v_dtype, void* stream) {
  const long long* s = strides;
  const FwdArgs a{View{q, s[0], s[1], s[2]},
                  View{k, s[3], s[4], s[5]},
                  View{v, s[6], s[7], s[8]},
                  contiguous_view(out, N, H, D),
                  nullptr,
                  nullptr,
                  B, N, H, D, 0,
                  static_cast<cudaStream_t>(stream)};
  if (takes_long_wgmma(a, qk_dtype, v_dtype)) return (int)attention_fwd_long(a, qk_dtype);
  if (qk_dtype == v_dtype) return (int)attention_fwd_mma_sync(a, qk_dtype);
  if (qk_dtype == 0 && v_dtype == 1) return (int)attention_fwd_tf32(a);
  return (int)cudaErrorInvalidValue;
}
