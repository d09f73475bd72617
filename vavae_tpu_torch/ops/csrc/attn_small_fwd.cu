// Attention forward on separate q, k, v, with optional in-kernel split-half
// RoPE, for sm_90a.
//
// Replaces vavae_tpu/ops/pallas/flash_attention.py:_attn_kernel_small_rope
// (use_rope = 1) and _attn_kernel_small (use_rope = 0), launched by
// _forward for N <= 1024, and the padding and layout copies around them: the
// TPU pads each half of the head dim to 64 and folds (B, H) into (B*H, N, 128)
// before the kernel. Here q, k and v are read in place through their own
// batch, token and head strides (v is a strided view of the qkv projection
// on the qk-norm path) and the output is written as (B, N, H, D). The device
// bodies, their numerics and their design are in attention_fwd_wgmma.cuh
// (bf16, D <= 128, N <= 1024, 16-byte aligned rows: the main paths),
// attention_tf32.cuh (fp32, D <= 128: 3xTF32 on the tensor cores) and
// attention_fwd.cuh (every other call), shared with nat_attention_fwd.cu.
//
// Bound on an H100 SXM at the main-path shape (B=16, H=16, N=256, D=72,
// bf16): 4*B*H*N^2*D = 4.83 GFLOP -> 4.9 us at 989 TFLOP/s, against
// (3 + 1)*B*N*H*D*2 = 37.7 MB of input and output -> 11.3 us at 3.35 TB/s,
// so the bound is the bytes.

#include "attention_fwd_wgmma.cuh"

// q, k, v: (B, N, H, D) with element strides strides[3*i .. 3*i + 2] =
// (batch, token, head) for i = q, k, v, and stride 1 over D; cos, sin:
// (N, D) fp32 split-half tables as the model holds them (the kernel folds the
// sign of sin), read only when use_rope; out: (B, N, H, D) contiguous.
// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error code of the launch
// (0 on success). Shapes are checked by the Python wrapper: N >= 1, even
// D <= 256.
extern "C" int attn_small_fwd(const void* q, const void* k, const void* v, const void* cos_t,
                              const void* sin_t, void* out, const long long* strides, int B,
                              int N, int H, int D, int use_rope, int dtype, void* stream) {
  const long long* s = strides;
  const FwdArgs a{View{q, s[0], s[1], s[2]},
                  View{k, s[3], s[4], s[5]},
                  View{v, s[6], s[7], s[8]},
                  contiguous_view(out, N, H, D),
                  static_cast<const float*>(cos_t),
                  static_cast<const float*>(sin_t),
                  B, N, H, D, use_rope,
                  static_cast<cudaStream_t>(stream)};
  return (int)attention_fwd(a, dtype);
}
