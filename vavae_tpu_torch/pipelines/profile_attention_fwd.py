"""Where the attention forward's device time goes, on the card.

    python -m vavae_tpu_torch.pipelines.profile_attention_fwd [--body small|long|both] [--out FILE.json]

Builds copies of a forward source whose wgmma body has parts taken out, and
times each copy with ``vavae_tpu_torch/utils/device_timing.py`` (device ms,
one profiler trace) beside the kernel as it is and SDPA:

- small: ``nat_attention_fwd.cu`` over ``ops/csrc/attention_fwd_wgmma.cuh``
  at (16, 16, 256, 72) and (4, 16, 1024, 72), with and without RoPE;
- long: ``flash_fwd.cu`` over ``ops/csrc/flash_fwd_wgmma.cuh`` at the 1024²
  path's (4, 16, 4096, 72), fp32 q̃, k̃ with bf16 v (and all bf16), SDPA on
  q̃, k̃ cast to bf16.

The copies compute wrong results on purpose: each reading is the kernel's
time without that part. Then times a loop of the bodies' products alone
(S: m64n64k16 bf16 and m64n64k8 TF32 with both operands in shared memory;
P.V: m64n80k16 and m64n72k16 with A in registers and V read MN-major; all on
the core-matrix layout without swizzle), 512 blocks of two warpgroups, as
TFLOP/s. Needs one NVIDIA Hopper GPU and nvcc; builds under
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
SHAPES = [(16, 16, 256, 72), (4, 16, 1024, 72)]
LONG_SHAPE = (4, 16, 4096, 72)

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

# the long body: the prologue's tiles are loaded, no later one
LONG_NO_LOADS = [("    if (t >= tiles) return;", "    if (t >= tiles || t >= kAhead) return;")]
LONG_NO_ROUNDING = [(re.compile(r"    if constexpr \(L::kTf32\) \{\n#pragma unroll\n.*?\n    \}\n", re.S), "")]
LONG_NO_PRODUCTS = [("    long_dot<TQK, L::kQkChunks>(s, q_wg, stage(t));",
                     "    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 1e-3f * j;"),
                    ("    long_pv<DP>(o, pa, stage(t) + L::kKTile);", "    o[0][0] += pa[0][0] * 1e-9f;")]
LONG_ABLATIONS = {
    "as is": [],
    "no TF32 rounding of k~ tiles": LONG_NO_ROUNDING,
    "no in-loop loads": LONG_NO_LOADS,
    "no softmax": NO_SOFTMAX,
    "no in-loop loads, no softmax": LONG_NO_LOADS + NO_SOFTMAX,
    "no in-loop loads, no softmax, no products": LONG_NO_LOADS + NO_SOFTMAX + LONG_NO_PRODUCTS,
}
# body: (header edited, source built, ablations)
BODIES = {"small": ("attention_fwd_wgmma.cuh", "nat_attention_fwd", ABLATIONS),
          "long": ("flash_fwd_wgmma.cuh", "flash_fwd", LONG_ABLATIONS)}

MICRO = r"""
#include "wgmma_common.cuh"
#include <cstdio>
// MODE 0: S, bf16 (five k16 steps over 80 columns); 1: P.V, n80; 2: S, TF32
// (nine k8 steps over 72 fp32 columns); 3: P.V, n72
template <int MODE>
__global__ void __launch_bounds__(256, 2) products(float* out, int reps) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RB = MODE == 2 ? 288 : 160;  // bytes of an operand row
  unsigned char* a = smem;
  unsigned char* b = a + 128 * RB;
  for (int i = threadIdx.x; i < 192 * RB / 4; i += 256)
    reinterpret_cast<uint32_t*>(smem)[i] = MODE == 2 ? __float_as_uint(1e-3f * (i % 13)) : 0x3c003c00u;
  fence_async_smem();
  __syncthreads();
  const unsigned char* a_wg = a + (threadIdx.x / 128) * 64 * RB;
  float s[8][4] = {}, o[10][4] = {};
  uint32_t pa[4][4];
  for (int kk = 0; kk < 4; ++kk) for (int i = 0; i < 4; ++i) pa[kk][i] = 0x3c003c00u;
  for (int r = 0; r < reps; ++r) {
    wgmma_fence();
    if (MODE == 0 || MODE == 2) {  // S's k-steps, accumulating across repetitions: no product is dead
      const uint64_t da = gmma_desc(a_wg, 128, 8 * RB), db = gmma_desc(b, 128, 8 * RB);
#pragma unroll
      for (int ks = 0; ks < RB / 32; ++ks) {
        if (MODE == 0)
          wgmma_ss<64, 0, 0>(&s[0][0], gmma_step(da, ks * 256), gmma_step(db, ks * 256), 1);
        else
          wgmma_tf32_n64(&s[0][0], gmma_step(da, ks * 256), gmma_step(db, ks * 256), 1);
      }
    }
    if (MODE == 1) gmma_pv<80>(o, pa, reinterpret_cast<const bf16*>(b));
    if (MODE == 3) gmma_pv<72>(*reinterpret_cast<float(*)[9][4]>(&o[0][0]), pa, reinterpret_cast<const bf16*>(b));
    wgmma_commit();
    wgmma_wait_all();
  }
  float sum = 0.f;
  for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) sum += s[j][e];
  for (int j = 0; j < 10; ++j) for (int e = 0; e < 4; ++e) sum += o[j][e];
  out[blockIdx.x * 256 + threadIdx.x] = sum;
}
template <int MODE>
float run(float* out, int blocks, int reps) {
  const int smem = 192 * 288;
  cudaFuncSetAttribute(products<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  products<MODE><<<blocks, 256, smem>>>(out, reps);
  cudaEventRecord(e0);
  products<MODE><<<blocks, 256, smem>>>(out, reps);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}
int main() {
  float* out;
  cudaMalloc(&out, 512 * 256 * 4);
  const int reps = 2000, blocks = 512;
  const char* names[4] = {"S", "PV", "S_tf32", "PV_n72"};
  const double macs[4] = {5.0 * 64 * 64 * 16, 4.0 * 64 * 80 * 16, 9.0 * 64 * 64 * 8, 4.0 * 64 * 72 * 16};
  const float ms[4] = {run<0>(out, blocks, reps), run<1>(out, blocks, reps),
                       run<2>(out, blocks, reps), run<3>(out, blocks, reps)};
  for (int m = 0; m < 4; ++m)
    printf("%s %.1f\n", names[m], 2.0 * macs[m] * 2 * blocks * reps / ms[m] / 1e9);
  return cudaGetLastError() != cudaSuccess;
}
"""


def _variant(body: str, name: str, edits) -> Path:
    header, source, _ = BODIES[body]
    d = OUT / body / re.sub(r"\W+", "_", name).strip("_")
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, d)
    text = (d / header).read_text()
    for old, new in edits:
        pattern = old if isinstance(old, re.Pattern) else re.compile(re.escape(old))
        text, n = pattern.subn(lambda _: new, text)
        if n != 1:
            raise RuntimeError(f"{body} {name}: {pattern.pattern[:60]!r} matched {n} times")
    (d / header).write_text(text)
    so = d / f"{source}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(d / f"{source}.cu")],
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


def _small_rows(libs: dict) -> list:
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
                rows.append({"body": "small", "shape": [B, H, N, D], "rope": rope, "variant": name,
                             "device_ms": ms})
                print(f"[ablation] small {(B, H, N, D)} rope={rope} {name}: {ms:.4f} ms", flush=True)
        q, k, v = (t.transpose(1, 2).contiguous() for t in qkv.unbind(dim=2))
        sdpa = sum(device_kernels(
            lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v)).values())
        rows.append({"body": "small", "shape": [B, H, N, D], "variant": "SDPA", "device_ms": sdpa})
        print(f"[ablation] small {(B, H, N, D)} SDPA: {sdpa:.4f} ms", flush=True)
    return rows


def _long_rows(libs: dict) -> list:
    from vavae_tpu_torch.ops.flash_attention import _strides, rope_uncast

    fns = {}
    for name, so in libs.items():
        fn = ctypes.CDLL(str(so)).flash_fwd
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda").manual_seed(1)
    B, H, N, D = LONG_SHAPE
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda").bfloat16()
    cos, sin = (torch.as_tensor(t[:N], device="cuda") for t in rope_2d_freqs(D, int(N ** 0.5)))
    rotated = [rope_uncast(qkv[:, :, i], (cos, sin)) for i in range(2)]
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for q, k in (rotated, (qkv[:, :, 0], qkv[:, :, 1])):
        v = qkv[:, :, 2]
        out = torch.empty((B, N, H, D), dtype=q.dtype, device="cuda")
        strides = _strides(q, k, v)
        code = 0 if q.dtype == torch.float32 else 1
        pair = f"{str(q.dtype)[6:]} q~, k~, bf16 v"
        for name, fn in fns.items():
            if "TF32" in name and code:
                continue
            def call(fn=fn):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                         ctypes.addressof(strides), B, N, H, D, code, 1, stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            ms = sum(device_kernels(call).values())
            rows.append({"body": "long", "shape": [B, H, N, D], "pair": pair, "variant": name,
                         "device_ms": ms})
            print(f"[ablation] long {(B, H, N, D)} {pair} {name}: {ms:.4f} ms", flush=True)
    qt, kt, vt = (t.to(torch.bfloat16).transpose(1, 2).contiguous() for t in (*rotated, qkv[:, :, 2]))
    sdpa = sum(device_kernels(
        lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)).values())
    rows.append({"body": "long", "shape": [B, H, N, D], "variant": "SDPA", "device_ms": sdpa})
    print(f"[ablation] long {(B, H, N, D)} SDPA (bf16): {sdpa:.4f} ms", flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--body", choices=("small", "long", "both"), default="both")
    ap.add_argument("--out", help="write the readings to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_attention_fwd: no CUDA device", file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    bodies = ("small", "long") if args.body == "both" else (args.body,)
    jobs = [(body, name, edits) for body in bodies for name, edits in BODIES[body][2].items()]
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc per copy, all at once
        built = list(pool.map(lambda job: _variant(*job), jobs))
    libs = {body: {} for body in bodies}
    for (body, name, _), so in zip(jobs, built):
        libs[body][name] = so
    rows = []
    if "small" in libs:
        rows += _small_rows(libs["small"])
    if "long" in libs:
        rows += _long_rows(libs["long"])
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
