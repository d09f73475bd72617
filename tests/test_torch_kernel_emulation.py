"""The CUDA attention kernels' own sources, run on the CPU.

There is no nvcc on a CPU-only machine, so ``nat_attention_fwd.cu``,
``nat_attention_bwd.cu``, ``attn_small_fwd.cu``, ``attn_small_bwd.cu`` and
``flash_fwd.cu`` (with the ``.cuh`` headers they include inlined) are
compiled as host C++ against a small emulation of the CUDA features they
use (below): one std::thread per CUDA thread, std::barrier for
``__syncthreads``, ``__syncwarp`` and the shuffles, ``mma.sync`` (bf16 and
TF32) and ``ldmatrix`` evaluated per warp from the documented fragment
layouts, ``cvt.rna.tf32``, ``cp.async`` as an immediate copy (so its wait
and the proxy fence are no-ops), and ``wgmma`` evaluated for each thread's
own accumulator elements from the PTX ISA's layouts: operands in shared
memory decoded from the matrix descriptor (start address, leading and stride
byte offsets, no swizzle; K-major, or MN-major with the transpose bit; TF32
operands read as their TF32 bits), an A operand in registers gathered from
the warp's fragments, each product evaluated at issue (so a missing wgmma
wait does not show here), and mbarriers (init, arrive, parity wait) as a
counter per barrier. Shared memory starts as NaN, so a read of
an element the kernel never wrote shows up in the output. The kernels then
run blocks one after the other on small shapes and are held against their
plain versions (``fused_qkv_attention_reference``,
``fused_qkv_attention_bwd_reference``, ``flash_attention_reference``,
``flash_attention_bwd_reference``, ``flash_attention_long_reference``).

This checks the kernels' indexing, masking, online softmax and fragment
bookkeeping; whether it compiles for sm_90a and how fast it runs only the
card can say (tests/test_torch_cuda.py, chip_smoke.py).
"""
import ctypes
import re
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vavae_tpu_torch.models.posembed import rope_2d_freqs
from vavae_tpu_torch.ops.flash_attention import (
    _strides,
    flash_attention_bwd_reference,
    flash_attention_long_reference,
    flash_attention_reference,
    fold_sin,
    fused_qkv_attention_bwd_reference,
    fused_qkv_attention_reference,
    rope_uncast,
)

CSRC = Path(__file__).resolve().parents[1] / "vavae_tpu_torch/ops/csrc"
SOURCE = CSRC / "nat_attention_fwd.cu"
BWD_SOURCE = CSRC / "nat_attention_bwd.cu"
SMALL_SOURCE = CSRC / "attn_small_fwd.cu"
SMALL_BWD_SOURCE = CSRC / "attn_small_bwd.cu"
LONG_SOURCE = CSRC / "flash_fwd.cu"

EMULATION = r"""#include <barrier>
#include <cmath>
#include <condition_variable>
#include <mutex>
#include <cstdint>
#include <cstring>
#include <functional>
#include <limits>
#include <map>
#include <thread>
#include <tuple>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__
struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
inline thread_local dim3 threadIdx, blockIdx, gridDim;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
// the dynamic shared memory each kernel may take: 48 KB, or what was set for it
inline std::map<const void*, size_t> g_max_smem;
template <class F> cudaError_t cudaFuncSetAttribute(F f, cudaFuncAttribute, int v) {
  g_max_smem[reinterpret_cast<const void*>(f)] = v; return v > 232448 ? 1 : 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
// a card of three SMs holding one block each: a persistent kernel's three
// blocks stride over the items
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
enum { cudaErrorInvalidConfiguration = 9 };
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 3; return 0; }
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
struct __nv_bfloat16 { uint16_t x; };
inline float __bfloat162float(__nv_bfloat16 b) { uint32_t u = (uint32_t)b.x << 16; float f; memcpy(&f, &u, 4); return f; }
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
// one block's state: shared memory (NaN at the start), its barriers and the
// per-thread exchange slots of shuffles, mma.sync, wgmma and ldmatrix; each
// emulated thread points at its block's
struct EmuBlock {
  std::vector<float> smem;
  std::barrier<> bar;
  // mbarriers, by byte offset in shared memory: arrivals a phase takes,
  // arrivals so far, phases completed
  struct Mbar { int expected = 0, count = 0, phase = 0; };
  std::map<size_t, Mbar> mbars;
  std::mutex mbar_m;
  std::condition_variable mbar_cv;
  std::vector<std::barrier<>*> warps;
  float xchg[1024];
  uint32_t mma_a[1024][4], mma_b[1024][2], wg_a[1024][4];
  const void* ldm[1024];
  EmuBlock(size_t bytes, int threads)
      : smem(bytes / 4 + 1, std::numeric_limits<float>::quiet_NaN()), bar(threads) {
    for (int w = 0; w < threads / 32; ++w) warps.push_back(new std::barrier<>(32));
  }
  ~EmuBlock() { for (auto* w : warps) delete w; }
};
inline thread_local EmuBlock* g_block = nullptr;
inline thread_local float* g_smem = nullptr;
inline thread_local std::barrier<>* g_cluster_bar = nullptr;
#define g_warp_bar (g_block->warps)
#define g_xchg (g_block->xchg)
#define g_mma_a (g_block->mma_a)
#define g_mma_b (g_block->mma_b)
#define g_wg_a (g_block->wg_a)
#define g_ldm_ptr (g_block->ldm)
inline void __syncthreads() { g_block->bar.arrive_and_wait(); }
// mbarrier.init / arrive / try_wait.parity on the block's table
inline EmuBlock::Mbar& emu_mbar(void* bar) { return g_block->mbars[(char*)bar - (char*)g_smem]; }
inline void emu_mbar_init(void* bar, int count) {
  std::lock_guard<std::mutex> lk(g_block->mbar_m);
  emu_mbar(bar) = EmuBlock::Mbar{count, 0, 0};
}
inline void emu_mbar_arrive(void* bar) {
  std::lock_guard<std::mutex> lk(g_block->mbar_m);
  EmuBlock::Mbar& b = emu_mbar(bar);
  if (++b.count == b.expected) { b.count = 0; ++b.phase; g_block->mbar_cv.notify_all(); }
}
inline void emu_mbar_wait(void* bar, int parity) {
  std::unique_lock<std::mutex> lk(g_block->mbar_m);
  g_block->mbar_cv.wait(lk, [&] { return (emu_mbar(bar).phase & 1) != parity; });
}
inline void __syncwarp() { g_warp_bar[threadIdx.x / 32]->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int m) {
  int t = threadIdx.x; g_xchg[t] = v; g_warp_bar[t / 32]->arrive_and_wait();
  float r = g_xchg[t ^ m]; g_warp_bar[t / 32]->arrive_and_wait(); return r;
}
// the blocks of a cluster (cluster consecutive blocks along x) run together,
// each with its own shared memory; clusters one after the other
inline void emu_launch(const void* fn, dim3 grid, int threads, size_t smem, std::function<void()> body,
                       unsigned cluster = 1) {
  if (smem > 48 * 1024 && smem > g_max_smem[fn]) throw 1;
  for (unsigned z = 0; z < grid.z; ++z) for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned x0 = 0; x0 < grid.x; x0 += cluster) {
      std::vector<EmuBlock*> blocks;
      for (unsigned c = 0; c < cluster; ++c) blocks.push_back(new EmuBlock(smem, threads));
      std::barrier<> cbar(cluster * threads);
      std::vector<std::thread> ts;
      for (unsigned c = 0; c < cluster; ++c)
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([=, &cbar] {
            g_block = blocks[c]; g_smem = blocks[c]->smem.data(); g_cluster_bar = &cbar;
            threadIdx = dim3(t, 0, 0); blockIdx = dim3(x0 + c, y, z); gridDim = grid; body();
          });
      for (auto& t : ts) t.join();
      for (auto* b : blocks) delete b;
    }
}
// cudaLaunchKernelEx with a cluster dimension along x
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute { cudaLaunchAttributeID id; struct { struct { unsigned x, y, z; } clusterDim; } val; };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim; size_t dynamicSmemBytes; cudaStream_t stream; cudaLaunchAttribute* attrs; unsigned numAttrs;
};
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, void (*k)(P...), A&&... args) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeClusterDimension) cluster = c->attrs[i].val.clusterDim.x;
  if (cluster < 1 || cluster > 8 || c->gridDim.x % cluster) return 1;
  std::tuple<P...> a(args...);
  emu_launch(reinterpret_cast<const void*>(k), c->gridDim, c->blockDim.x, c->dynamicSmemBytes,
             [=] { std::apply(k, a); }, cluster);
  return 0;
}
#define __align__(x)
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) { return {__float2bfloat16(a), __float2bfloat16(b)}; }
// bf16x2 arithmetic, one rounding per operation (a product or sum of two bf16
// is exact in fp32, or its rounding to bf16 is unaffected)
inline __nv_bfloat162 emu_bf162(float a, float b) { return __floats2bfloat162_rn(a, b); }
inline __nv_bfloat162 __hmul2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return emu_bf162(__bfloat162float(a.x) * __bfloat162float(b.x), __bfloat162float(a.y) * __bfloat162float(b.y));
}
inline __nv_bfloat162 __hadd2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return emu_bf162(__bfloat162float(a.x) + __bfloat162float(b.x), __bfloat162float(a.y) + __bfloat162float(b.y));
}
inline __nv_bfloat162 __hsub2(__nv_bfloat162 a, __nv_bfloat162 b) {
  return emu_bf162(__bfloat162float(a.x) - __bfloat162float(b.x), __bfloat162float(a.y) - __bfloat162float(b.y));
}
inline float bf_lo(uint32_t u) { return __bfloat162float({(uint16_t)(u & 0xffff)}); }
inline float bf_hi(uint32_t u) { return __bfloat162float({(uint16_t)(u >> 16)}); }
inline void emu_mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  int t = threadIdx.x, w = t / 32, base = w * 32;
  for (int i = 0; i < 4; ++i) g_mma_a[t][i] = a[i];
  for (int i = 0; i < 2; ++i) g_mma_b[t][i] = b[i];
  g_warp_bar[w]->arrive_and_wait();
  float A[16][16], B[16][8];
  for (int l = 0; l < 32; ++l) {
    int g = l / 4, c = l % 4; const uint32_t* aa = g_mma_a[base + l]; const uint32_t* bb = g_mma_b[base + l];
    A[g][2*c] = bf_lo(aa[0]); A[g][2*c+1] = bf_hi(aa[0]);
    A[g+8][2*c] = bf_lo(aa[1]); A[g+8][2*c+1] = bf_hi(aa[1]);
    A[g][2*c+8] = bf_lo(aa[2]); A[g][2*c+9] = bf_hi(aa[2]);
    A[g+8][2*c+8] = bf_lo(aa[3]); A[g+8][2*c+9] = bf_hi(aa[3]);
    B[2*c][g] = bf_lo(bb[0]); B[2*c+1][g] = bf_hi(bb[0]);
    B[2*c+8][g] = bf_lo(bb[1]); B[2*c+9][g] = bf_hi(bb[1]);
  }
  int lane = t % 32, g = lane / 4, c = lane % 4;
  for (int k = 0; k < 16; ++k) {
    d[0] += A[g][k] * B[k][2*c]; d[1] += A[g][k] * B[k][2*c+1];
    d[2] += A[g+8][k] * B[k][2*c]; d[3] += A[g+8][k] * B[k][2*c+1];
  }
  g_warp_bar[w]->arrive_and_wait();
}
// cp.async: the copy happens at once (src_bytes < 16 zero-fills the rest)
inline void emu_cp_async16(void* dst, const void* src, int src_bytes) {
  memset(dst, 0, 16); if (src_bytes > 0) memcpy(dst, src, src_bytes);
}
struct float2 { float x, y; };
struct uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline size_t __cvta_generic_to_shared(const void* p) { return (size_t)((const char*)p - (const char*)g_smem); }
// element (mn, k) of a wgmma operand in shared memory: core matrices of 8x16
// bytes without swizzle, sbo bytes apart along M/N and lbo bytes along K;
// K-major rows run along k, MN-major rows along mn
inline float emu_gmma_el(uint64_t desc, int mn, int k, int mn_major) {
  if (desc >> 62) throw 2;  // only the layout without swizzle is emulated
  const size_t lbo = ((desc >> 16) & 0x3fff) << 4, sbo = ((desc >> 32) & 0x3fff) << 4;
  size_t off = ((desc & 0x3fff) << 4) + (mn / 8) * sbo + (k / 8) * lbo;
  off += mn_major ? (k % 8) * 16 + (mn % 8) * 2 : (mn % 8) * 16 + (k % 8) * 2;
  __nv_bfloat16 v; memcpy(&v, (const char*)g_smem + off, 2); return __bfloat162float(v);
}
// wgmma m64nNk16 (f32 += bf16 . bf16) for the calling thread's elements: rows
// 16*(warp % 4) + lane/4 (+8) and columns 8j + 2*(lane % 4) (+1) of the
// warpgroup's 64 x N, as d[4j .. 4j + 3]. a: the A fragment in registers
// (the m16n8k16 layout of the warp's 16 rows), else A from shared memory.
inline void emu_wgmma(float* d, int N, int ta, int tb, uint64_t da, const uint32_t* a, uint64_t db, int acc) {
  const int t = threadIdx.x, w = (t / 32) % 4, l = t % 32;
  float A[2][16];
  if (a) {
    for (int i = 0; i < 4; ++i) g_wg_a[t][i] = a[i];
    g_warp_bar[t / 32]->arrive_and_wait();
    const int quad = (t / 32) * 32 + (l / 4) * 4;
    for (int c = 0; c < 4; ++c) {
      const uint32_t* f = g_wg_a[quad + c];
      A[0][2*c] = bf_lo(f[0]); A[0][2*c+1] = bf_hi(f[0]);
      A[1][2*c] = bf_lo(f[1]); A[1][2*c+1] = bf_hi(f[1]);
      A[0][2*c+8] = bf_lo(f[2]); A[0][2*c+9] = bf_hi(f[2]);
      A[1][2*c+8] = bf_lo(f[3]); A[1][2*c+9] = bf_hi(f[3]);
    }
    g_warp_bar[t / 32]->arrive_and_wait();
  } else {
    for (int h = 0; h < 2; ++h) for (int k = 0; k < 16; ++k) A[h][k] = emu_gmma_el(da, w * 16 + l / 4 + 8 * h, k, ta);
  }
  for (int j = 0; j < N / 8; ++j) for (int e = 0; e < 4; ++e) {
    const int col = j * 8 + 2 * (l % 4) + (e & 1);
    float sum = 0.f;
    for (int k = 0; k < 16; ++k) sum += A[e >> 1][k] * emu_gmma_el(db, col, k, tb);
    d[4 * j + e] = (acc ? d[4 * j + e] : 0.f) + sum;
  }
}
inline float2 make_float2(float a, float b) { return {a, b}; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
// cvt.rna.tf32.f32: to nearest on the 10-bit mantissa, ties away from zero
inline float emu_round_tf32(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return __uint_as_float(u);
}
// the tensor cores read only the TF32 bits of each operand
inline float tf32_of(uint32_t u) { return __uint_as_float(u & 0xffffe000u); }
inline void emu_mma_tf32(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  int t = threadIdx.x, w = t / 32, base = w * 32;
  for (int i = 0; i < 4; ++i) g_mma_a[t][i] = a[i];
  for (int i = 0; i < 2; ++i) g_mma_b[t][i] = b[i];
  g_warp_bar[w]->arrive_and_wait();
  float A[16][8], B[8][8];
  for (int l = 0; l < 32; ++l) {
    int g = l / 4, c = l % 4; const uint32_t* aa = g_mma_a[base + l]; const uint32_t* bb = g_mma_b[base + l];
    A[g][c] = tf32_of(aa[0]); A[g+8][c] = tf32_of(aa[1]);
    A[g][c+4] = tf32_of(aa[2]); A[g+8][c+4] = tf32_of(aa[3]);
    B[c][g] = tf32_of(bb[0]); B[c+4][g] = tf32_of(bb[1]);
  }
  int lane = t % 32, g = lane / 4, c = lane % 4;
  for (int k = 0; k < 8; ++k) {
    d[0] += A[g][k] * B[k][2*c]; d[1] += A[g][k] * B[k][2*c+1];
    d[2] += A[g+8][k] * B[k][2*c]; d[3] += A[g+8][k] * B[k][2*c+1];
  }
  g_warp_bar[w]->arrive_and_wait();
}
inline void emu_ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1, const __nv_bfloat16* row) {
  int t = threadIdx.x, w = t / 32, base = w * 32, lane = t % 32;
  g_ldm_ptr[t] = row;
  g_warp_bar[w]->arrive_and_wait();
  int g = lane / 4, c = lane % 4;
  auto el = [&](int m, int r, int col) { return ((const __nv_bfloat16*)g_ldm_ptr[base + m * 8 + r])[col]; };
  auto pk = [](__nv_bfloat16 lo, __nv_bfloat16 hi) { return (uint32_t)lo.x | ((uint32_t)hi.x << 16); };
  b0 = pk(el(0, 2 * c, g), el(0, 2 * c + 1, g));
  b1 = pk(el(1, 2 * c, g), el(1, 2 * c + 1, g));
  g_warp_bar[w]->arrive_and_wait();
}
// element (mn, k) of a 32-bit K-major wgmma operand (TF32) in shared memory:
// core matrices of 8 rows x 4 elements (16 bytes), read as its TF32 bits
inline float emu_gmma_el32(uint64_t desc, int mn, int k) {
  if (desc >> 62) throw 2;  // only the layout without swizzle is emulated
  const size_t lbo = ((desc >> 16) & 0x3fff) << 4, sbo = ((desc >> 32) & 0x3fff) << 4;
  const size_t off = ((desc & 0x3fff) << 4) + (mn / 8) * sbo + (k / 4) * lbo + (mn % 8) * 16 + (k % 4) * 4;
  uint32_t u; memcpy(&u, (const char*)g_smem + off, 4); return tf32_of(u);
}
// wgmma m64nNk8 (f32 += tf32 . tf32), A and B from shared memory, both
// K-major (TF32 has no transpose); d as in emu_wgmma
inline void emu_wgmma_tf32(float* d, int N, uint64_t da, uint64_t db, int acc) {
  const int t = threadIdx.x, w = (t / 32) % 4, l = t % 32;
  float A[2][8];
  for (int h = 0; h < 2; ++h) for (int k = 0; k < 8; ++k) A[h][k] = emu_gmma_el32(da, w * 16 + l / 4 + 8 * h, k);
  for (int j = 0; j < N / 8; ++j) for (int e = 0; e < 4; ++e) {
    const int col = j * 8 + 2 * (l % 4) + (e & 1);
    float sum = 0.f;
    for (int k = 0; k < 8; ++k) sum += A[e >> 1][k] * emu_gmma_el32(db, col, k);
    d[4 * j + e] = (acc ? d[4 * j + e] : 0.f) + sum;
  }
}
"""


def expand_includes(path: Path, seen=None) -> str:
    """The source with each ``#include "header"`` replaced by the header's
    own expanded text, once per header (its include guard)."""
    seen = set() if seen is None else seen

    def inline(m):
        header = path.parent / m.group(1)
        if header in seen:
            return ""
        seen.add(header)
        return expand_includes(header, seen)

    return re.sub(r'^#include "([^"]+)"$', inline, path.read_text(), flags=re.M)


def _host_source(src: str, launches: int = 2) -> str:
    """The kernel source with shared memory, its inline-PTX helpers (those of
    ``attention_common.cuh`` in every source, the ``cp.async``, fence and
    ``wgmma`` ones where the backward header defines them) and its
    ``launches`` ``<<<...>>>`` launches routed to the emulation."""
    src = src.replace("extern __shared__ float smem[];", "float* smem = g_smem;")
    src = src.replace("extern __shared__ __align__(16) unsigned char mma_smem[];",
                      "unsigned char* mma_smem = (unsigned char*)g_smem;")
    for ret, name, emu, sig in [
        ("void", "mma_m16n8k16_bf16", "emu_mma(d, a, b)",
         "float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]"),
        ("void", "mma_m16n8k8_tf32", "emu_mma_tf32(d, a, b)",
         "float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]"),
        ("float", "round_tf32", "return emu_round_tf32(x)", "float x"),
        ("float", "ex2_ftz", "return exp2f(x)", "float x"),
        ("void", "ldmatrix_x2_trans", "emu_ldmatrix_x2_trans(b0, b1, row)",
         "uint32_t& b0, uint32_t& b1, const __nv_bfloat16* row"),
        ("void", "cp_async16", "emu_cp_async16(dst, src, src_bytes)",
         "void* dst, const void* src, int src_bytes"),
        ("void", "cp_async_wait_all", "(void)0", ""),
        ("void", "cp_async_commit", "(void)0", ""),
        ("void", "cp_async_wait", "(void)0", ""),
        ("void", "fence_async_smem", "(void)0", ""),
        ("void", "wgmma_fence", "(void)0", ""),
        ("void", "wgmma_commit", "(void)0", ""),
        ("void", "wgmma_wait_all", "(void)0", ""),
        ("void", "mbar_init", "emu_mbar_init(bar, count)", "uint64_t* bar, int count"),
        ("void", "mbar_arrive", "emu_mbar_arrive(bar)", "uint64_t* bar"),
        ("void", "mbar_wait", "emu_mbar_wait(bar, parity)", "uint64_t* bar, int parity"),
        ("void", "cluster_sync", "g_cluster_bar->arrive_and_wait()", ""),
        ("void", "fence_operand", "(void)x", "float& x"),
        ("void", "wgmma_tf32_n64", "emu_wgmma_tf32(d, 64, da, db, acc)",
         "float* d, uint64_t da, uint64_t db, int acc"),
    ] + [
        ("void", f"wgmma_ss_n{n}", f"emu_wgmma(d, {n}, TA, TB, da, nullptr, db, acc)",
         "float* d, uint64_t da, uint64_t db, int acc") for n in (64, 40, 32, 16)
    ] + [
        ("void", f"wgmma_rs_n{n}", f"emu_wgmma(d, {n}, 0, TB, 0, a, db, acc)",
         "float* d, const uint32_t* a, uint64_t db, int acc") for n in (128, 80, 72, 64, 32)
    ]:
        src, n = re.subn(rf"__device__ __forceinline__ {ret} {name}\(.*?\n}}\n",
                         f"inline {ret} {name}({sig}) {{ {emu}; }}\n", src, flags=re.S)
        assert n == 1 or (n == 0 and f"{name}(" not in src), name
    src, n = re.subn(
        r"(\w+<[^;<>]*>)<<<(.*?)>>>\((.*?)\);",
        lambda m: (f"{{ auto* kfn = &{m.group(1)}; emu_launch(reinterpret_cast<const void*>(kfn), "
                   f"{m.group(2).rsplit(',', 1)[0]}, "
                   f"[=] {{ kfn({m.group(3)}); }}); }}"),
        src, flags=re.S)
    assert n == launches, n
    return src


def build_host_library(d: Path, source: str, launches: int) -> ctypes.CDLL:
    """Compile a kernel source as host C++ against the emulation, in ``d``."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    (d / "inc").mkdir(exist_ok=True)
    for header in ("cuda_bf16.h", "cuda_runtime.h"):
        (d / "inc" / header).write_text("")
    (d / "emulation.h").write_text(EMULATION)
    (d / "kernel.cpp").write_text(_host_source(source, launches))
    lib = d / "libnat_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-fPIC", "-shared", f"-I{d / 'inc'}",
                    "-include", str(d / "emulation.h"), "-o", str(lib), str(d / "kernel.cpp"),
                    "-lpthread"], check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


# launches in a backward source: prep, stats, main and dq for bf16, two for fp32
BWD_LAUNCHES = 6
# <<<...>>> launches in a small-route forward source: the mma.sync and the
# fp32 FMA bodies (the wgmma body goes through cudaLaunchKernelEx)
FWD_LAUNCHES = 2


def _raw_table_ptrs(rope):
    """The forward entries' tables: the split-half (cos, sin) as the model
    holds them, fp32 and contiguous, and the tensors to keep alive."""
    if rope is None:
        return None, None, ()
    cos, sin = (torch.as_tensor(t, dtype=torch.float32).contiguous() for t in rope)
    return cos.data_ptr(), sin.data_ptr(), (cos, sin)


def _with_scratch_size(lib: ctypes.CDLL, name: str, fn):
    """``fn`` and the library's ``<name>_scratch_bytes`` together."""
    size = getattr(lib, f"{name}_scratch_bytes")
    size.argtypes = [ctypes.c_int] * 5
    size.restype = ctypes.c_longlong
    return SimpleNamespace(run=fn, scratch_bytes=size)


def scratch_for(kernel, B, N, H, D, dtype) -> torch.Tensor:
    """The kernel's scratch, NaN-filled: a read of a byte it never wrote
    shows up in the output."""
    n = kernel.scratch_bytes(B, N, H, D, {torch.float32: 0, torch.bfloat16: 1}[dtype])
    return torch.full((n // 4 + 64,), float("nan"), dtype=torch.float32)


def bwd_function(lib: ctypes.CDLL):
    fn = lib.nat_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _with_scratch_size(lib, "nat_attention_bwd", fn)


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    fn = build_host_library(tmp_path_factory.mktemp("nat_emu"), expand_includes(SOURCE),
                            FWD_LAUNCHES).nat_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def bwd_kernel(tmp_path_factory):
    lib = build_host_library(tmp_path_factory.mktemp("nat_bwd_emu"), expand_includes(BWD_SOURCE),
                             BWD_LAUNCHES)
    return bwd_function(lib)


def _run(kernel, qkv: torch.Tensor, rope):
    """The forward entry on the model's raw split-half tables (the kernel
    folds the sign of sin)."""
    B, N, _, H, D = qkv.shape
    out = torch.full((B, N, H, D), float("nan"), dtype=qkv.dtype)
    cos, sin, keep = _raw_table_ptrs(rope)
    ptrs = (cos, sin)
    code = {torch.float32: 0, torch.bfloat16: 1}[qkv.dtype]
    err = kernel(qkv.data_ptr(), ptrs[0], ptrs[1], out.data_ptr(), B, N, H, D,
                 int(rope is not None), code, None)
    assert err == 0
    return out


def _tables(N, D):
    if D % 4:  # the 2-D tables need D % 4 == 0; any angles exercise the rotation
        ang = np.random.default_rng(D).uniform(0, 6.3, (N, D)).astype(np.float32)
        return torch.from_numpy(np.cos(ang)), torch.from_numpy(np.sin(ang))
    cos, sin = rope_2d_freqs(D, int(np.ceil(N ** 0.5)))
    return torch.from_numpy(cos[:N]).contiguous(), torch.from_numpy(sin[:N]).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D,rope", [
    (2, 64, 2, 72, True),    # the XL head dim, one full tile
    (1, 100, 1, 64, False),  # a ragged second key tile
    (1, 130, 2, 8, True),    # three query tiles, a tiny head dim
    (1, 1, 1, 72, True),     # one token
    (1, 70, 1, 256, True),   # the widest head dim
    (1, 33, 1, 250, True),   # D % 8 != 0: scalar loads, odd D/2
])
def test_kernel_source_matches_plain_version(kernel, B, N, H, D, rope, dtype):
    # fp32: summation order only. bf16: at most two bf16 steps of the output
    # where the online softmax rounds P against a running instead of the
    # final row max (2e-2 max-abs is the TPU kernel's tolerance)
    qkv = torch.randn((B, N, 3, H, D), generator=torch.Generator().manual_seed(N)).to(dtype)
    tables = _tables(N, D) if rope else None
    got = _run(kernel, qkv, tables)
    want = fused_qkv_attention_reference(qkv, tables)
    assert not torch.isnan(got.float()).any()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_kernel_source_misaligned_input(kernel):
    """A bf16 view that is not 16-byte aligned takes the scalar-load path."""
    B, N, H, D = 1, 70, 2, 72
    buf = torch.randn(B * N * 3 * H * D + 1, generator=torch.Generator().manual_seed(0))
    qkv = buf.bfloat16()[1:].view(B, N, 3, H, D)
    assert qkv.data_ptr() % 16 != 0
    tables = _tables(N, D)
    got = _run(kernel, qkv, tables)
    want = fused_qkv_attention_reference(qkv, tables)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


# Calls that the wgmma body (attention_fwd_wgmma.cuh) takes: bf16, D <= 128,
# every row 16-byte aligned, N <= 1024. The cases above with D > 128, D % 8
# != 0, fp32 or a misaligned view stay on the first bodies (attention_fwd.cuh).
WGMMA_CASES = [
    (1, 256, 2, 72, True),   # the XL head dim at the main paths' N: two query blocks, four key tiles
    (1, 200, 2, 72, True),   # ragged N: the last key tile holds 8 keys and 56 masked ones
    (1, 700, 1, 72, True),   # eleven key tiles: the three-stage ring wraps three times
    (2, 130, 1, 64, False),  # D = 64 without RoPE, a ragged second query block
    (1, 150, 1, 128, True),  # the widest head dim the body takes (DP = 128)
    (1, 64, 2, 64, True),    # the micro-Doppler DiT-S/2 (N = 64): half a query block, one
                             # key tile, a RoPE cluster of one block
    (1, 64, 1, 64, False),
]


@pytest.mark.parametrize("B,N,H,D,rope", WGMMA_CASES)
def test_wgmma_fwd_source_matches_plain_version(kernel, B, N, H, D, rope):
    # bf16 2e-2 max-abs, the TPU kernel's tolerance, as above
    qkv = torch.randn((B, N, 3, H, D), generator=torch.Generator().manual_seed(N)).bfloat16()
    tables = _tables(N, D) if rope else None
    got = _run(kernel, qkv, tables)
    assert not torch.isnan(got.float()).any()
    assert (got.float() - fused_qkv_attention_reference(qkv, tables).float()).abs().max() <= 2e-2


# Four faults planted in copies of the wgmma body, which the bf16 check must
# catch: the running sum and accumulator not rescaled when the row max grows,
# the keys past N left unmasked, the k tiles not rotated, and the sign of sin
# not folded. The cases that stay on the first bodies must pass all the same.
FWD_MUTATIONS = {
    "no_rescale": ("    const float alpha0 = exp2f(m0 - mn0);\n    const float alpha1 = exp2f(m1 - mn1);",
                   "    const float alpha0 = 1.f;\n    const float alpha1 = 1.f;"),
    "no_tail_mask": ("if (k0 + j * 8 + 2 * cq + (e & 1) >= N) s[j][e] = -INFINITY;",
                     "if (k0 + j * 8 + 2 * cq + (e & 1) >= N) s[j][e] += 0.f;"),
    "k_not_rotated": ("      rope_bf16x2(yl.x, yh.x, c0, c1, s0, s1);\n      rope_bf16x2(yl.y, yh.y, c0 + 2, c1 + 2, s0 + 2, s1 + 2);\n", ""),
    "sign_not_folded": ("lo = as_u32(__hsub2(", "lo = as_u32(__hadd2("),
}


def _mutated_fwd(tmp_path, source: Path, name: str) -> ctypes.CDLL:
    old, new = FWD_MUTATIONS[name]
    text = expand_includes(source)
    assert text.count(old) == 1, name
    return build_host_library(tmp_path, text.replace(old, new), FWD_LAUNCHES)


@pytest.mark.parametrize("name", list(FWD_MUTATIONS))
def test_wgmma_fwd_emulation_catches_mutations(tmp_path, name):
    fn = _mutated_fwd(tmp_path, SOURCE, name).nat_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    qkv = torch.randn((1, 200, 3, 2, 72), generator=torch.Generator().manual_seed(3)).bfloat16()
    tables = _tables(200, 72)
    err = (_run(fn, qkv, tables).float() - fused_qkv_attention_reference(qkv, tables).float())
    assert err.abs().max().item() > 2e-2
    # fp32, and a bf16 view that is not 16-byte aligned: the first bodies
    B, N, H, D = 1, 70, 2, 72
    buf = torch.randn(B * N * 3 * H * D + 1, generator=torch.Generator().manual_seed(0))
    tables = _tables(N, D)
    for qkv, tol in ((buf[1:].view(B, N, 3, H, D), 1e-5),
                     (buf.bfloat16()[1:].view(B, N, 3, H, D), 2e-2)):
        want = fused_qkv_attention_reference(qkv, tables)
        assert (_run(fn, qkv, tables).float() - want.float()).abs().max().item() <= tol


def run_bwd(kernel, qkv: torch.Tensor, g: torch.Tensor, rope):
    B, N, _, H, D = qkv.shape
    dqkv = torch.full_like(qkv, float("nan"))
    scratch = scratch_for(kernel, B, N, H, D, qkv.dtype)
    if rope is not None:
        cos, sinf = fold_sin(rope)
        ptrs = (cos.data_ptr(), sinf.data_ptr())
    else:
        ptrs = (None, None)
    code = {torch.float32: 0, torch.bfloat16: 1}[qkv.dtype]
    err = kernel.run(qkv.data_ptr(), g.data_ptr(), ptrs[0], ptrs[1], dqkv.data_ptr(),
                     scratch.data_ptr(), B, N, H, D, int(rope is not None), code, None)
    assert err == 0
    return dqkv


def bwd_case(B, N, H, D, rope, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed + N)
    qkv = torch.randn((B, N, 3, H, D), generator=gen).to(dtype)
    g = torch.randn((B, N, H, D), generator=gen).to(dtype)
    return qkv, g, _tables(N, D) if rope else None


def bwd_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |err| / max |ref| (the TPU kernel's own measure, tests/test_ops.py:188-190)"""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D,rope", [
    (1, 64, 1, 72, True),    # the XL head dim, one full tile in both passes
    (1, 100, 2, 8, True),    # N not a multiple of 64: ragged query and key tiles
    (2, 70, 1, 72, False),   # no RoPE, two batches
    (1, 256, 1, 72, True),   # four streamed tiles through the two-stage ring, two key blocks
    (1, 50, 2, 18, True),    # D % 4 != 0: one column per item in the prep and dq passes
    (1, 100, 1, 128, True),  # the widest head dim (DP = 128)
    (1, 70, 1, 96, False),   # D = 96 padded to 128
    (2, 64, 2, 64, True),    # the micro-Doppler DiT-S/2's likelihood (N = 64, D = 64)
])
def test_bwd_kernel_source_matches_plain_version(bwd_kernel, B, N, H, D, rope, dtype):
    # fp32: summation order only (and the kernel's P = exp(s - m)·(1/l));
    # bf16: 3e-2 of max|ref|, the TPU backward kernel's own tolerance
    qkv, g, tables = bwd_case(B, N, H, D, rope, dtype)
    got = run_bwd(bwd_kernel, qkv, g, tables)
    want = fused_qkv_attention_bwd_reference(qkv, g, tables)
    assert not torch.isnan(got.float()).any()
    if dtype == torch.float32:
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert bwd_error(got, want) <= 3e-2


def test_bwd_kernel_source_misaligned_input(bwd_kernel):
    """bf16 views that are not 16-byte aligned take the scalar-load path."""
    B, N, H, D = 1, 70, 1, 72
    gen = torch.Generator().manual_seed(1)
    buf = torch.randn(B * N * 3 * H * D + 1, generator=gen).bfloat16()
    qkv = buf[1:].view(B, N, 3, H, D)
    g = torch.randn(B * N * H * D + 1, generator=gen).bfloat16()[1:].view(B, N, H, D)
    assert qkv.data_ptr() % 16 != 0
    tables = _tables(N, D)
    got = run_bwd(bwd_kernel, qkv, g, tables)
    assert bwd_error(got, fused_qkv_attention_bwd_reference(qkv, g, tables)) <= 3e-2


# Two faults that the test above must catch, each applied to a copy of the
# source's bf16 body: delta (rowsum(dP∘P)) left out of dS in the main pass,
# and dq/dk written without the transposed RoPE.
MUTATIONS = {
    "no_delta": ("p * (dpt[j][e] - dl_s[c]) * scale", "p * dpt[j][e] * scale"),
    "no_transposed_rope": ("  return make_float2(x0 * c0 + x1 * s1, x1 * c1 + x0 * s0);",
                           "  return make_float2(x0 + 0.f * (c0 + s1), x1 + 0.f * (c1 + s0));"),
}


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_bwd_emulation_catches_mutations(tmp_path, name):
    old, new = MUTATIONS[name]
    source = expand_includes(BWD_SOURCE)
    assert source.count(old) >= 1, name
    fn = bwd_function(build_host_library(tmp_path, source.replace(old, new), BWD_LAUNCHES))
    qkv, g, tables = bwd_case(1, 64, 1, 72, True, torch.bfloat16)
    got = run_bwd(fn, qkv, g, tables)
    assert bwd_error(got, fused_qkv_attention_bwd_reference(qkv, g, tables)) > 3e-2


# -- separate q, k, v: attn_small_fwd.cu and attn_small_bwd.cu ---------------------


@pytest.fixture(scope="module")
def small_kernel(tmp_path_factory):
    lib = build_host_library(tmp_path_factory.mktemp("small_emu"), expand_includes(SMALL_SOURCE),
                             FWD_LAUNCHES)
    fn = lib.attn_small_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def small_bwd_function(lib: ctypes.CDLL):
    fn = lib.attn_small_bwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _with_scratch_size(lib, "attn_small_bwd", fn)


@pytest.fixture(scope="module")
def small_bwd_kernel(tmp_path_factory):
    src = expand_includes(SMALL_BWD_SOURCE)
    return small_bwd_function(build_host_library(tmp_path_factory.mktemp("small_bwd_emu"), src,
                                                 BWD_LAUNCHES))


def _table_ptrs(rope):
    """The backward entries' tables: cos and the sign-folded sin."""
    if rope is None:
        return None, None, ()
    cos, sinf = fold_sin(rope)
    return cos.data_ptr(), sinf.data_ptr(), (cos, sinf)


def run_small(kernel, q, k, v, rope):
    B, N, H, D = q.shape
    out = torch.full((B, N, H, D), float("nan"), dtype=q.dtype)
    cos, sinf, keep = _raw_table_ptrs(rope)
    strides = _strides(q, k, v)
    code = {torch.float32: 0, torch.bfloat16: 1}[q.dtype]
    err = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos, sinf, out.data_ptr(),
                 ctypes.addressof(strides), B, N, H, D, int(rope is not None), code, None)
    assert err == 0
    return out


def run_small_bwd(kernel, q, k, v, g, rope):
    B, N, H, D = q.shape
    grads = [torch.full((B, N, H, D), float("nan"), dtype=q.dtype) for _ in range(3)]
    scratch = scratch_for(kernel, B, N, H, D, q.dtype)
    cos, sinf, keep = _table_ptrs(rope)
    strides = _strides(q, k, v, g)
    code = {torch.float32: 0, torch.bfloat16: 1}[q.dtype]
    err = kernel.run(q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), cos, sinf,
                     *(t.data_ptr() for t in grads), scratch.data_ptr(), ctypes.addressof(strides),
                     B, N, H, D, int(rope is not None), code, None)
    assert err == 0
    return grads


def small_case(B, N, H, D, rope, dtype, seed=0, offset=0):
    """q, k fresh (B, N, H, D) tensors (the q/k norms' outputs), v the strided
    view qkv[:, :, 2] of a (B, N, 3, H, D) tensor that starts ``offset``
    elements into its buffer; g and the tables."""
    gen = torch.Generator().manual_seed(seed + N)
    q, k, g = (torch.randn((B, N, H, D), generator=gen).to(dtype) for _ in range(3))
    buf = torch.randn(offset + B * N * 3 * H * D, generator=gen).to(dtype)
    v = buf[offset:].view(B, N, 3, H, D)[:, :, 2]
    return q, k, v, g, _tables(N, D) if rope else None


SMALL_CASES = [
    (2, 64, 2, 72, True),    # the XL head dim, one full tile
    (1, 100, 3, 64, False),  # ragged key tiles, odd H, no RoPE
    (1, 130, 1, 8, True),    # three query tiles, a tiny head dim
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D,rope", SMALL_CASES)
def test_small_kernel_source_matches_plain_version(small_kernel, B, N, H, D, rope, dtype):
    # as test_kernel_source_matches_plain_version: fp32 1e-5, bf16 2e-2 max-abs
    q, k, v, _, tables = small_case(B, N, H, D, rope, dtype)
    assert not v.is_contiguous()
    got = run_small(small_kernel, q, k, v, tables)
    want = flash_attention_reference(q, k, v, tables)
    assert not torch.isnan(got.float()).any()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_small_kernel_source_misaligned_input(small_kernel):
    """A strided bf16 v whose rows are not 16-byte aligned takes the
    scalar-load path."""
    q, k, v, _, tables = small_case(1, 70, 2, 72, True, torch.bfloat16, offset=1)
    assert v.data_ptr() % 16 != 0
    got = run_small(small_kernel, q, k, v, tables)
    want = flash_attention_reference(q, k, v, tables)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("B,N,H,D,rope", WGMMA_CASES)
def test_small_wgmma_fwd_source_matches_plain_version(small_kernel, B, N, H, D, rope):
    """The wgmma body through the separate-q/k/v entry, v a strided view."""
    q, k, v, _, tables = small_case(B, N, H, D, rope, torch.bfloat16, seed=2)
    got = run_small(small_kernel, q, k, v, tables)
    assert not torch.isnan(got.float()).any()
    assert (got.float() - flash_attention_reference(q, k, v, tables).float()).abs().max() <= 2e-2


@pytest.mark.parametrize("name", list(FWD_MUTATIONS))
def test_small_wgmma_fwd_emulation_catches_mutations(tmp_path, name):
    """The same four faults through attn_small_fwd.cu; its misaligned view
    and fp32 inputs stay on the first bodies and pass."""
    fn = _mutated_fwd(tmp_path, SMALL_SOURCE, name).attn_small_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    q, k, v, _, tables = small_case(1, 200, 2, 72, True, torch.bfloat16, seed=3)
    err = run_small(fn, q, k, v, tables).float() - flash_attention_reference(q, k, v, tables).float()
    assert err.abs().max().item() > 2e-2
    for dtype, offset, tol in ((torch.float32, 0, 1e-5), (torch.bfloat16, 1, 2e-2)):
        q, k, v, _, tables = small_case(1, 70, 2, 72, True, dtype, offset=offset)
        want = flash_attention_reference(q, k, v, tables)
        assert (run_small(fn, q, k, v, tables).float() - want.float()).abs().max().item() <= tol


def _small_bwd_error(got, want) -> float:
    return max(bwd_error(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,N,H,D,rope", [
    (1, 64, 1, 72, True),    # the XL head dim, one full tile in both passes
    (1, 100, 2, 8, True),    # ragged query and key tiles
    (2, 70, 1, 72, False),   # no RoPE: no tables are passed
    (1, 256, 1, 72, True),   # four streamed tiles through the two-stage ring, two key blocks
    (1, 40, 2, 12, True),    # D % 8 != 0: column pairs in the prep and dq passes, scalar tiles
    (1, 100, 1, 128, True),  # the widest head dim (DP = 128)
    (1, 70, 1, 96, False),   # D = 96 padded to 128
])
def test_small_bwd_kernel_source_matches_plain_version(small_bwd_kernel, B, N, H, D, rope, dtype):
    # fp32 1e-5 max-abs; bf16 3e-2 of max|ref| for each of dq, dk, dv
    q, k, v, g, tables = small_case(B, N, H, D, rope, dtype, seed=5)
    got = run_small_bwd(small_bwd_kernel, q, k, v, g, tables)
    want = flash_attention_bwd_reference(q, k, v, g, tables)
    assert not any(torch.isnan(t.float()).any() for t in got)
    if dtype == torch.float32:
        assert max((a - b).abs().max().item() for a, b in zip(got, want)) <= 1e-5
    else:
        assert _small_bwd_error(got, want) <= 3e-2


def test_small_bwd_kernel_source_misaligned_input(small_bwd_kernel):
    q, k, v, g, tables = small_case(1, 70, 1, 72, True, torch.bfloat16, seed=6, offset=3)
    assert v.data_ptr() % 16 != 0
    got = run_small_bwd(small_bwd_kernel, q, k, v, g, tables)
    assert _small_bwd_error(got, flash_attention_bwd_reference(q, k, v, g, tables)) <= 3e-2


@pytest.mark.parametrize("name", list(MUTATIONS))
def test_small_bwd_emulation_catches_mutations(tmp_path, name):
    """The same two faults in attn_small_bwd.cu (through the body it shares
    with nat_attention_bwd.cu) must fail the check above."""
    old, new = MUTATIONS[name]
    source = expand_includes(SMALL_BWD_SOURCE)
    assert source.count(old) >= 1, name
    fn = small_bwd_function(build_host_library(tmp_path, source.replace(old, new), BWD_LAUNCHES))
    q, k, v, g, tables = small_case(1, 64, 1, 72, True, torch.bfloat16, seed=5)
    got = run_small_bwd(fn, q, k, v, g, tables)
    assert _small_bwd_error(got, flash_attention_bwd_reference(q, k, v, g, tables)) > 3e-2


# -- the long route: flash_fwd.cu ---------------------------------------------------


# <<<...>>> launches in flash_fwd.cu: the wgmma body, the mma.sync and the
# fp32 FMA bodies
LONG_LAUNCHES = 3


def long_function(lib: ctypes.CDLL):
    fn = lib.flash_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@pytest.fixture(scope="module")
def long_kernel(tmp_path_factory):
    src = expand_includes(LONG_SOURCE)
    return long_function(build_host_library(tmp_path_factory.mktemp("long_emu"), src,
                                            LONG_LAUNCHES))


def run_long(kernel, q, k, v):
    B, N, H, D = q.shape
    out = torch.full((B, N, H, D), float("nan"), dtype=q.dtype)
    strides = _strides(q, k, v)
    code = {torch.float32: 0, torch.bfloat16: 1}
    err = kernel(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), B, N, H, D, code[q.dtype], code[v.dtype], None)
    assert err == 0
    return out


def long_case(B, N, H, D, qk_dtype, v_dtype, seed=0, offset=0):
    """q̃, k̃ and v as the long route hands them to the kernel: v the strided
    view qkv[:, :, 2] of a (B, N, 3, H, D) projection that starts ``offset``
    elements into its buffer; q̃, k̃ its q and k rotated with the fp32 tables
    (fp32, contiguous) or, for bf16 q̃, k̃, its unrotated strided views (a
    ``use_rope: false`` model)."""
    gen = torch.Generator().manual_seed(seed + N)
    buf = torch.randn(offset + B * N * 3 * H * D, generator=gen).to(v_dtype)
    qkv = buf[offset:].view(B, N, 3, H, D)
    if qk_dtype == torch.bfloat16:
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    tables = _tables(N, D)
    q, k = (rope_uncast(qkv[:, :, i], tables) for i in range(2))
    assert q.dtype == torch.float32
    return q, k, qkv[:, :, 2]


F32, BF16 = torch.float32, torch.bfloat16
LONG_REL_TOL = 5e-3


def long_rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm()).item()


def assert_long_close(got, want, v_dtype):
    """All fp32: summation order only, 1e-5 max-abs. With bf16 v (TF32 or
    bf16 q̃·k̃ᵀ, P rounded to bf16 against a running max where the plain
    version rounds it against the final one): 2e-2 max-abs, the TPU kernel's
    tolerance, and LONG_REL_TOL relative (Frobenius) error, the limit that
    the planted faults below must exceed."""
    err = (got.float() - want.float()).abs().max().item()
    if v_dtype == torch.float32:
        assert err <= 1e-5
    else:
        assert err <= 2e-2
        assert long_rel_err(got, want) <= LONG_REL_TOL


@pytest.mark.parametrize("B,N,H,D,qk_dtype,v_dtype", [
    (1, 100, 2, 72, F32, BF16),   # the RoPE models' pair, N not a multiple of 64
    (2, 130, 1, 16, F32, BF16),   # three query tiles, a ragged last key tile
    (1, 100, 2, 72, BF16, BF16),  # use_rope: false, q and k strided views
    (1, 70, 3, 72, F32, F32),     # fp32 models: the FMA kernel
])
def test_long_kernel_source_matches_plain_version(long_kernel, B, N, H, D, qk_dtype, v_dtype):
    q, k, v = long_case(B, N, H, D, qk_dtype, v_dtype)
    got = run_long(long_kernel, q, k, v)
    want = flash_attention_long_reference(q, k, v)
    assert got.dtype == want.dtype == qk_dtype
    assert not torch.isnan(got.float()).any()
    assert_long_close(got, want, v_dtype)


def test_long_kernel_source_misaligned_input(long_kernel):
    """A bf16 v whose rows are not 16-byte aligned sends the TF32 kernel to
    scalar loads for all three inputs."""
    q, k, v = long_case(1, 90, 2, 72, F32, BF16, seed=1, offset=1)
    assert v.data_ptr() % 16 != 0
    got = run_long(long_kernel, q, k, v)
    assert_long_close(got, flash_attention_long_reference(q, k, v), v.dtype)


def test_long_emulation_catches_mutation(tmp_path):
    """A TF32 B fragment read from the wrong column (kt[0] for kt[4]) must
    fail the check above: the emulation runs the TF32 mma.sync path's
    fragments, which takes a v whose rows are not 16-byte aligned."""
    old = "__float_as_uint(kt[4])"
    source = expand_includes(LONG_SOURCE)
    assert source.count(old) == 1
    fn = long_function(build_host_library(tmp_path, source.replace(old, "__float_as_uint(kt[0])"),
                                          LONG_LAUNCHES))
    q, k, v = long_case(1, 100, 2, 72, F32, BF16, offset=1)
    assert v.data_ptr() % 16 != 0
    got = run_long(fn, q, k, v)
    assert (got - flash_attention_long_reference(q, k, v)).abs().max().item() > 2e-2


LONG_MUTATIONS = {
    # the zero-filled keys past N enter the softmax with logit 0
    "no_tail_mask": ("s[j][e] = valid ? s[j][e] * scale : -INFINITY;",
                     "s[j][e] = s[j][e] * scale + 0.f * valid;"),
    # the running sums and the accumulator are not rescaled when the row max grows
    "no_rescale": ("    const float alpha0 = expf(m0 - mn0);\n    const float alpha1 = expf(m1 - mn1);",
                   "    const float alpha0 = 1.f;\n    const float alpha1 = 1.f;"),
}


@pytest.mark.parametrize("qk_dtype", [F32, BF16])
@pytest.mark.parametrize("name", list(LONG_MUTATIONS))
def test_long_emulation_catches_planted_faults(tmp_path, name, qk_dtype):
    """A dropped tail mask or a dropped rescale in the shared mma.sync body
    must exceed LONG_REL_TOL, for the TF32 and the bf16 q̃·k̃ᵀ, at an N
    whose last key tile holds one key (the chip check's N = 4,033 case).
    The inputs' rows are not 16-byte aligned, which keeps the call on that
    body."""
    old, new = LONG_MUTATIONS[name]
    source = expand_includes(LONG_SOURCE)
    assert source.count(old) == 1, name
    fn = long_function(build_host_library(tmp_path, source.replace(old, new), LONG_LAUNCHES))
    q, k, v = long_case(1, 129, 2, 72, qk_dtype, BF16, offset=1)
    assert v.data_ptr() % 16 != 0
    got = run_long(fn, q, k, v)
    assert long_rel_err(got, flash_attention_long_reference(q, k, v)) > LONG_REL_TOL


# Calls that the wgmma body (flash_fwd_wgmma.cuh) takes: fp32 or bf16 q̃, k̃
# with bf16 v, D % 8 == 0, D <= 72, every row 16-byte aligned, any N.
LONG_WGMMA_CASES = [
    (1, 1100, 1, 72, F32, BF16),  # the main path's pair past SMALL_SEQ_MAX: 18 key tiles, 12 in the last
    (1, 200, 2, 72, F32, BF16),   # two query blocks, the second ragged; 8 keys in the last tile
    (2, 129, 1, 64, F32, BF16),   # DP = 64; one key in the last tile
    (1, 70, 1, 16, F32, BF16),    # a narrow head dim, zero-padded to DP = 64
    (1, 1100, 1, 72, BF16, BF16),  # use_rope: false, q and k strided views, bf16 S
    (1, 200, 2, 64, BF16, BF16),
]


@pytest.mark.parametrize("B,N,H,D,qk_dtype,v_dtype", LONG_WGMMA_CASES)
def test_long_wgmma_source_matches_plain_version(long_kernel, B, N, H, D, qk_dtype, v_dtype):
    # limits as in assert_long_close
    q, k, v = long_case(B, N, H, D, qk_dtype, v_dtype, seed=4)
    assert not v.is_contiguous() and v.data_ptr() % 16 == 0
    got = run_long(long_kernel, q, k, v)
    want = flash_attention_long_reference(q, k, v)
    assert got.dtype == want.dtype == qk_dtype
    assert not torch.isnan(got.float()).any()
    assert_long_close(got, want, v_dtype)


# Faults planted in copies of the wgmma body, which the check must catch:
# the keys past N left unmasked, no rescale when the row max grows, and the
# TF32 k-steps' descriptors moved on by one core matrix (16 bytes of a row)
# instead of two.
LONG_WGMMA_MUTATIONS = {
    "no_tail_mask": ("if (k0 + j * 8 + 2 * cq + (e & 1) >= N) s[j][e] = -INFINITY;",
                     "if (k0 + j * 8 + 2 * cq + (e & 1) >= N) s[j][e] += 0.f;"),
    "no_rescale": ("    const float alpha0 = ex2_ftz(m0 - mn0);\n    const float alpha1 = ex2_ftz(m1 - mn1);",
                   "    const float alpha0 = 1.f;\n    const float alpha1 = 1.f;"),
    "k_step_offset": ("wgmma_tf32_n64(&s[0][0], gmma_step(dq, ks * 256), gmma_step(dk, ks * 256)",
                      "wgmma_tf32_n64(&s[0][0], gmma_step(dq, ks * 128), gmma_step(dk, ks * 128)"),
}


@pytest.mark.parametrize("name", list(LONG_WGMMA_MUTATIONS))
def test_long_wgmma_emulation_catches_planted_faults(tmp_path, name):
    """Each fault exceeds LONG_REL_TOL on the main path's pair at an N whose
    last key tile holds one key; the all-fp32 pair and a misaligned v stay
    on the first bodies and pass."""
    old, new = LONG_WGMMA_MUTATIONS[name]
    source = expand_includes(LONG_SOURCE)
    assert source.count(old) == 1, name
    fn = long_function(build_host_library(tmp_path, source.replace(old, new), LONG_LAUNCHES))
    q, k, v = long_case(1, 129, 2, 72, F32, BF16, seed=5)
    assert long_rel_err(run_long(fn, q, k, v), flash_attention_long_reference(q, k, v)) > LONG_REL_TOL
    for v_dtype, offset in ((F32, 0), (BF16, 1)):
        q, k, v = long_case(1, 70, 2, 72, F32, v_dtype, seed=6, offset=offset)
        assert_long_close(run_long(fn, q, k, v), flash_attention_long_reference(q, k, v), v_dtype)
