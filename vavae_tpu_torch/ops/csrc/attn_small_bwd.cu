// Attention backward on separate q, k, v, with optional in-kernel split-half
// RoPE, for sm_90a.
//
// Replaces vavae_tpu/ops/pallas/flash_attention.py:_attn_bwd_kernel_small
// (the recompute backward of _attn_kernel_small_rope and _attn_kernel_small,
// launched by _bwd_pallas from the flash_attention custom VJP), and the
// padding and layout copies around it. Here q, k, v and the output gradient
// are read in place through their own batch, token and head strides, and
// dq, dk, dv are written as (B, N, H, D) each. Without RoPE the TPU kernel
// is handed ones/zeros tables and skips the rotation; here no tables are
// passed. The device bodies, their numerics and their design are in
// attention_bwd.cuh (bf16) and attention_tf32.cuh (fp32, 3xTF32 on the
// tensor cores), shared with nat_attention_bwd.cu: the TPU kernel's
// transposed rotation cat(y[D/2:], -y[:D/2]) of y = x*sin equals
// roll(x*sin', D/2) exactly.
//
// Bound on an H100 SXM at the training shape (B=32, H=16, N=256, D=72, bf16):
// (3 + 1 + 3)*B*N*H*D*2 = 132.1 MB of input and output -> 39.4 us at
// 3.35 TB/s, against 10*B*H*N^2*D = 24.2 GFLOP -> 24.4 us at 989 TFLOP/s, so
// the bound is the bytes.

#include "attention_bwd.cuh"

// q, k, v, g: (B, N, H, D) with element strides strides[3*i .. 3*i + 2] =
// (batch, token, head) for i = q, k, v, g, and stride 1 over D; g is the
// gradient of the forward's output; cos, sin: (N, D) fp32 (sin sign-folded),
// read only when use_rope; dq, dk, dv: (B, N, H, D) contiguous, written
// whole; scratch: attn_small_bwd_scratch_bytes(B, N, H, D, dtype) bytes,
// 256-byte aligned. dtype: 0 = float32, 1 = bfloat16. Returns the CUDA
// error code of the launches (0 on success). Shapes are checked by the
// Python wrapper: N >= 1, even D <= 128.
extern "C" int attn_small_bwd(const void* q, const void* k, const void* v, const void* g,
                              const void* cos_t, const void* sin_t, void* dq, void* dk, void* dv,
                              void* scratch, const long long* strides, int B, int N, int H, int D,
                              int use_rope, int dtype, void* stream) {
  const long long* s = strides;
  const BwdArgs a{View{q, s[0], s[1], s[2]},
                  View{k, s[3], s[4], s[5]},
                  View{v, s[6], s[7], s[8]},
                  View{g, s[9], s[10], s[11]},
                  contiguous_view(dq, N, H, D),
                  contiguous_view(dk, N, H, D),
                  contiguous_view(dv, N, H, D),
                  static_cast<const float*>(cos_t),
                  static_cast<const float*>(sin_t),
                  scratch,
                  B, N, H, D, use_rope,
                  static_cast<cudaStream_t>(stream)};
  return (int)attention_bwd(a, dtype);
}

// bytes of scratch attn_small_bwd needs for these shapes and dtype
extern "C" long long attn_small_bwd_scratch_bytes(int B, int N, int H, int D, int dtype) {
  return (long long)bwd_scratch_bytes(B, N, H, D, dtype);
}
