"""Where the small-route attention forward's device time goes, on the card.

    python -m vavae_tpu_torch.pipelines.profile_attention_fwd [--out FILE.json]

Builds copies of ``nat_attention_fwd.cu`` whose wgmma body
(``ops/csrc/attention_fwd_wgmma.cuh``) has parts taken out, and times each
copy with ``vavae_tpu_torch/utils/device_timing.py`` (device ms, one
profiler trace) beside the kernel as it is and SDPA, at (16, 16, 256, 72)
and (4, 16, 1024, 72), with and without RoPE. The copies compute wrong
results on purpose: each reading is the kernel's time without that part.
Then times a loop of the body's two products alone (S: m64n64k16 with both
operands in shared memory; P.V: m64n80k16 with A in registers and V read
MN-major; both on the core-matrix layout without swizzle), 512 blocks of two
warpgroups, as TFLOP/s. Needs one NVIDIA Hopper GPU and nvcc; builds under
``build/vavae_tpu_torch/ablation/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from vavae_tpu_torch.models.posembed import rope_2d_freqs
from vavae_tpu_torch.ops import build
from vavae_tpu_torch.utils.device_timing import device_kernels

OUT = build.BUILD_DIR / "ablation"
BODY = "attention_fwd_wgmma.cuh"
SHAPES = [(16, 16, 256, 72), (4, 16, 1024, 72)]

# each ablation: (text in the body, its replacement)
NO_LOADS = [("      const bf16* kr = kb", "      if (t >= 2) return;\n      const bf16* kr = kb")]
NO_SOFTMAX = [(re.compile(r"    // mask keys past N \(the last tile only\).*?(?=    // o \+= round\(P\))", re.S),
               "    l0 += s[0][0];\n    l1 += s[0][2];\n")]
NO_PRODUCTS = [("    gmma_dot<DP>(s, q_wg, k_s);",
                "    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 1e-3f * j;"),
               ("    gmma_pv<DP>(o, pa, v_s);", "    o[0][0] += pa[0][0] * 1e-9f;")]
ABLATIONS = {
    "as is": [],
    "no in-loop loads": NO_LOADS,
    "no softmax": NO_SOFTMAX,
    "no in-loop loads, no softmax": NO_LOADS + NO_SOFTMAX,
    "no in-loop loads, no softmax, no products": NO_LOADS + NO_SOFTMAX + NO_PRODUCTS,
}

MICRO = r"""
#include "wgmma_common.cuh"
#include <cstdio>
template <int MODE>
__global__ void __launch_bounds__(256, 2) products(float* out, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* a = reinterpret_cast<bf16*>(smem);
  bf16* b = a + 128 * 80;
  for (int i = threadIdx.x; i < 192 * 80; i += 256) a[i] = __float2bfloat16(1e-3f * (i % 13));
  fence_async_smem();
  __syncthreads();
  const bf16* a_wg = a + (threadIdx.x / 128) * 64 * 80;
  float s[8][4] = {}, o[10][4] = {};
  uint32_t pa[4][4];
  for (int kk = 0; kk < 4; ++kk) for (int i = 0; i < 4; ++i) pa[kk][i] = 0x3c003c00u;
  for (int r = 0; r < reps; ++r) {
    wgmma_fence();
    if (MODE == 0) {  // S's five k-steps, accumulating across repetitions: no product is dead
      const uint64_t da = gmma_desc(a_wg, 128, 80 * 16), db = gmma_desc(b, 128, 80 * 16);
#pragma unroll
      for (int ks = 0; ks < 5; ++ks)
        wgmma_ss<64, 0, 0>(&s[0][0], gmma_step(da, ks * 256), gmma_step(db, ks * 256), 1);
    }
    if (MODE == 1) gmma_pv<80>(o, pa, b);
    wgmma_commit();
    wgmma_wait_all();
  }
  float sum = 0.f;
  for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) sum += s[j][e];
  for (int j = 0; j < 10; ++j) for (int e = 0; e < 4; ++e) sum += o[j][e];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
}
int main() {
  float* out;
  cudaMalloc(&out, 512 * 256 * 4);
  const int smem = 192 * 80 * 2, reps = 2000, blocks = 512;
  cudaFuncSetAttribute(products<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(products<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int mode = 0; mode < 2; ++mode) {
    for (int i = 0; i < 2; ++i) {
      if (i) cudaEventRecord(e0);
      if (mode == 0) products<0><<<blocks, 256, smem>>>(out, reps);
      else products<1><<<blocks, 256, smem>>>(out, reps);
      if (i) cudaEventRecord(e1);
    }
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    const double macs = mode == 0 ? 5.0 * 64 * 64 * 16 : 4.0 * 64 * 80 * 16;
    printf("%s %.1f\n", mode == 0 ? "S" : "PV", 2.0 * macs * 2 * blocks * reps / ms / 1e9);
  }
  return cudaGetLastError() != cudaSuccess;
}
"""


def _variant(name: str, edits) -> Path:
    d = OUT / re.sub(r"\W+", "_", name).strip("_")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, d)
    text = (d / BODY).read_text()
    for old, new in edits:
        pattern = old if isinstance(old, re.Pattern) else re.compile(re.escape(old))
        text, n = pattern.subn(lambda _: new, text)
        if n != 1:
            raise RuntimeError(f"{name}: {pattern.pattern[:60]!r} matched {n} times")
    (d / BODY).write_text(text)
    so = d / "nat_attention_fwd.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(d / "nat_attention_fwd.cu")],
                   check=True, capture_output=True, text=True)
    return so


def _micro() -> dict:
    d = OUT / "products"
    d.mkdir(parents=True, exist_ok=True)
    (d / "products.cu").write_text(MICRO)
    exe = d / "products"
    subprocess.run([build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    f"-I{build.CSRC}", "-o", str(exe), str(d / "products.cu")],
                   check=True, capture_output=True, text=True)
    lines = subprocess.run([str(exe)], check=True, capture_output=True, text=True).stdout.split()
    return {lines[i]: float(lines[i + 1]) for i in range(0, len(lines), 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the readings to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_attention_fwd: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(ABLATIONS)) as pool:  # one nvcc per copy, all at once
        libs = dict(zip(ABLATIONS, pool.map(lambda kv: _variant(*kv), ABLATIONS.items())))
    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).nat_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for B, H, N, D in SHAPES:
        qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda").bfloat16()
        out = torch.empty((B, N, H, D), dtype=torch.bfloat16, device="cuda")
        cos, sin = (torch.as_tensor(t[:N], device="cuda") for t in rope_2d_freqs(D, int(N ** 0.5)))
        stream = torch.cuda.current_stream().cuda_stream
        for rope in (True, False):
            for name, fn in fns.items():
                def call(fn=fn, rope=rope):
                    err = fn(qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
                             B, N, H, D, int(rope), 1, stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                ms = sum(device_kernels(call).values())
                rows.append({"shape": [B, H, N, D], "rope": rope, "variant": name, "device_ms": ms})
                print(f"[ablation] {(B, H, N, D)} rope={rope} {name}: {ms:.4f} ms", flush=True)
        q, k, v = (t.transpose(1, 2).contiguous() for t in qkv.unbind(dim=2))
        sdpa = sum(device_kernels(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)).values())
        rows.append({"shape": [B, H, N, D], "variant": "SDPA", "device_ms": sdpa})
        print(f"[ablation] {(B, H, N, D)} SDPA: {sdpa:.4f} ms", flush=True)
    products = _micro()
    print(f"[ablation] products alone, TFLOP/s: {products}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    if args.out:
        Path(args.out).write_text(json.dumps({"device": smi, "rows": rows,
                                              "products_tflops": products}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
