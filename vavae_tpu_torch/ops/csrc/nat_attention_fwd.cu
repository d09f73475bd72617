// Fused-qkv attention forward with in-kernel split-half RoPE, for sm_90a.
//
// Replaces vavae_tpu/ops/pallas/flash_attention.py:_nat_fwd_kernel (and the
// two layout transposes around it in fused_qkv_attention). It reads the qkv
// projection output (B, N, 3, H, D) in place, strided, and writes
// (B, N, H, D) directly: the TPU's (B, 3, H, N, D) copy does not exist here.
// The device bodies, their numerics and their design are in
// attention_fwd_wgmma.cuh (bf16, D <= 128, N <= 1024: the main paths),
// attention_tf32.cuh (fp32, D <= 128: the micro-Doppler DiTs, 3xTF32 on the
// tensor cores) and attention_fwd.cuh (every other call).
//
// Bound on an H100 SXM at the main-path shape (B=16, H=16, N=256, D=72,
// bf16): 4*B*H*N^2*D = 4.83 GFLOP -> 4.9 us at 989 TFLOP/s, against
// (3 + 1)*B*N*H*D*2 = 37.7 MB of input and output -> 11.3 us at 3.35 TB/s,
// so the bound is the bytes.

#include "attention_fwd_wgmma.cuh"

// qkv: (B, N, 3, H, D) contiguous; cos, sin: (N, D) fp32 split-half tables
// as the model holds them (the kernel folds the sign of sin), read only when
// use_rope; out: (B, N, H, D). dtype: 0 = float32, 1 = bfloat16.
// Returns the CUDA error code of the launch (0 on success). Shapes are
// checked by the Python wrapper: N >= 1, even D <= 256.
extern "C" int nat_attention_fwd(const void* qkv, const void* cos_t, const void* sin_t,
                                 void* out, int B, int N, int H, int D, int use_rope,
                                 int dtype, void* stream) {
  const long long hd = (long long)H * D, sn = 3 * hd, sb = sn * N;
  const size_t item = dtype == 1 ? sizeof(__nv_bfloat16) : sizeof(float);
  const char* base = static_cast<const char*>(qkv);
  const FwdArgs a{View{base, sb, sn, D},
                  View{base + hd * item, sb, sn, D},
                  View{base + 2 * hd * item, sb, sn, D},
                  contiguous_view(out, N, H, D),
                  static_cast<const float*>(cos_t),
                  static_cast<const float*>(sin_t),
                  B, N, H, D, use_rope,
                  static_cast<cudaStream_t>(stream)};
  return (int)attention_fwd(a, dtype);
}
