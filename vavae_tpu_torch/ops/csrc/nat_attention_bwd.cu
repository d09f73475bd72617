// Fused-qkv attention backward with in-kernel split-half RoPE, for sm_90a.
//
// Replaces vavae_tpu/ops/pallas/flash_attention.py:_nat_bwd_kernel (the
// recompute backward of _nat_fwd_kernel, launched by _nat_bwd_rule). It reads
// the qkv projection output (B, N, 3, H, D) and the output gradient
// (B, N, H, D) in place, strided, and writes dq, dk, dv straight into a
// (B, N, 3, H, D) gradient: the layout of the qkv projection's output, so the
// TPU's (B, 3, H, N, D) copies do not exist here. The device bodies, their
// numerics and their design are in attention_bwd.cuh (bf16) and
// attention_tf32.cuh (fp32, 3xTF32 on the tensor cores).
//
// Bound on an H100 SXM at the training shape (B=32, H=16, N=256, D=72, bf16):
// (3 + 1 + 3)*B*N*H*D*2 = 132.1 MB of input and output -> 39.4 us at
// 3.35 TB/s, against 10*B*H*N^2*D = 24.2 GFLOP -> 24.4 us at 989 TFLOP/s, so
// the bound is the bytes, as for the forward. The bf16 scratch holds q~ and
// k~ rotated once, the row statistics and the per-key-block dq partials; the
// fp32 one is empty at N <= 64 and holds q~, k~, dq's sum over key tiles and
// the statistics for longer heads.

#include "attention_bwd.cuh"

// qkv: (B, N, 3, H, D) contiguous; dout: (B, N, H, D) contiguous, the
// gradient of the forward's output; cos, sin: (N, D) fp32 (sin sign-folded),
// read only when use_rope; dqkv: (B, N, 3, H, D), written whole; scratch:
// nat_attention_bwd_scratch_bytes(B, N, H, D, dtype) bytes, 256-byte aligned.
// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error code of the
// launches (0 on success). Shapes are checked by the Python wrapper: N >= 1,
// even D <= 128.
extern "C" int nat_attention_bwd(const void* qkv, const void* dout, const void* cos_t,
                                 const void* sin_t, void* dqkv, void* scratch, int B, int N,
                                 int H, int D, int use_rope, int dtype, void* stream) {
  const long long hd = (long long)H * D, sn = 3 * hd, sb = sn * N;
  const size_t item = dtype == 1 ? sizeof(__nv_bfloat16) : sizeof(float);
  const char* in = static_cast<const char*>(qkv);
  const char* out = static_cast<const char*>(dqkv);
  const BwdArgs a{View{in, sb, sn, D},
                  View{in + hd * item, sb, sn, D},
                  View{in + 2 * hd * item, sb, sn, D},
                  contiguous_view(dout, N, H, D),
                  View{out, sb, sn, D},
                  View{out + hd * item, sb, sn, D},
                  View{out + 2 * hd * item, sb, sn, D},
                  static_cast<const float*>(cos_t),
                  static_cast<const float*>(sin_t),
                  scratch,
                  B, N, H, D, use_rope,
                  static_cast<cudaStream_t>(stream)};
  return (int)attention_bwd(a, dtype);
}

// bytes of scratch nat_attention_bwd needs for these shapes and dtype
extern "C" long long nat_attention_bwd_scratch_bytes(int B, int N, int H, int D, int dtype) {
  return (long long)bwd_scratch_bytes(B, N, H, D, dtype);
}
