// Hopper building blocks shared by the wgmma attention bodies
// (attention_fwd_wgmma.cuh, flash_fwd_wgmma.cuh, attention_bwd.cuh):
// cp.async copies into shared memory, the core-matrix tile layout, wgmma
// matrix descriptors and the m64nNk16 (bf16 in) and m64n64k8 (TF32 in)
// products on it, fp32 accumulate, and the row loader.

#ifndef VAVAE_WGMMA_COMMON_CUH
#define VAVAE_WGMMA_COMMON_CUH

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 256;  // a block of two warpgroups

// 16 bytes from global to shared memory without blocking (cp.async, cached in
// L2 only); src_bytes 0 reads nothing and writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(addr), "l"(src), "r"(src_bytes)
               : "memory");
}

// waits until every cp.async this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// closes this thread's cp.async issued since the last commit into a group
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes this thread's shared-memory writes (stores and cp.async) visible to
// the tensor cores' reads of wgmma operands (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma ordering: fence before a batch (accumulator and A registers), commit
// the batch as a group, wait until no group is in flight
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// An mbarrier in shared memory: mbar_init sets the arrivals a phase takes
// (one thread, before a __syncthreads); mbar_arrive counts this thread's
// (release: its earlier writes are seen by a waiter); mbar_wait returns once
// the phase of the given parity has completed (acquire)
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(addr), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(addr)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(bar));
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// pins an accumulator register after a wgmma wait: the compiler may not move
// a read of it above the wait (cute's warpgroup_fence_operand)
__device__ __forceinline__ void fence_operand(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

// Shared-memory tiles are held in the core-matrix layout that wgmma reads
// without swizzling: 8x8 blocks of 128 contiguous bytes (8 rows of 16 bytes),
// the blocks of an 8-row group side by side along the COLS columns, the
// groups one after the other. Element offset of (r, c):
template <int COLS>
__device__ __forceinline__ int cm_off(int r, int c) {
  return (r >> 3) * (COLS * 8) + (c >> 3) * 64 + (r & 7) * 8 + (c & 7);
}

// wgmma matrix descriptor of a core-matrix tile without swizzle (layout type
// 0): start address, lbo = bytes between core matrices along K, sbo = along M
// or N (for K-major operands and, with the transpose bit, for MN-major ones)
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// a descriptor moved on by a byte offset (a multiple of 16)
__device__ __forceinline__ uint64_t gmma_step(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// m64nNk16 products, bf16 in, fp32 accumulate (acc 0: d = A.B, else d += A.B),
// each thread holding rows 16*(warp % 4) + lane/4 (+8) and columns 8j +
// 2*(lane % 4) (+1) of d as d[4j .. 4j + 3]: the mma.sync m16n8 fragment of
// every warp. ss: A and B from shared memory (TA/TB 1: MN-major); rs: A
// from registers, the m16n8k16 A fragment of the warp's 16 rows.

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n40(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19}, "
      "%20, %21, p, 1, 1, %23, %24;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// m64n64k8, TF32 in (each operand's raw fp32 bits, of which the tensor
// cores read the TF32 ones), fp32 accumulate; A and B from shared memory,
// both K-major (TF32 takes no transpose); d as in the m64nNk16 products
__device__ __forceinline__ void wgmma_tf32_n64(float* d, uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, %46;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n72(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35}, "
      "{%36, %37, %38, %39}, %40, p, 1, 1, %42;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc), "n"(TB));
}

// acc[N/2] (+)= A . B over one k-step of 16, as one m64nNk16 product (the N
// the kernels use: 64 for S and dP, DP/2 for a half of dq, DP for dv, dk)
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float* acc, uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 40 || N == 32 || N == 16, "no m64nNk16 wrapper for this N");
  if constexpr (N == 64) wgmma_ss_n64<TA, TB>(acc, da, db, accumulate);
  if constexpr (N == 40) wgmma_ss_n40<TA, TB>(acc, da, db, accumulate);
  if constexpr (N == 32) wgmma_ss_n32<TA, TB>(acc, da, db, accumulate);
  if constexpr (N == 16) wgmma_ss_n16<TA, TB>(acc, da, db, accumulate);
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs(float* acc, const uint32_t* a, uint64_t db,
                                         int accumulate) {
  static_assert(N == 128 || N == 80 || N == 72 || N == 64 || N == 32,
                "no m64nNk16 wrapper for this N");
  if constexpr (N == 128) wgmma_rs_n128<TB>(acc, a, db, accumulate);
  if constexpr (N == 80) wgmma_rs_n80<TB>(acc, a, db, accumulate);
  if constexpr (N == 72) wgmma_rs_n72<TB>(acc, a, db, accumulate);
  if constexpr (N == 64) wgmma_rs_n64<TB>(acc, a, db, accumulate);
  if constexpr (N == 32) wgmma_rs_n32<TB>(acc, a, db, accumulate);
}

// s (this warpgroup's 64 rows x 64 columns) = a . b^T over DP columns: a, b
// K-major core-matrix tiles of DP columns (a at the warpgroup's first row)
template <int DP>
__device__ __forceinline__ void gmma_dot(float (&s)[8][4], const bf16* a, const bf16* b) {
  const uint64_t da = gmma_desc(a, 128, DP * 16), db = gmma_desc(b, 128, DP * 16);
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks)
    wgmma_ss<64, 0, 0>(&s[0][0], gmma_step(da, ks * 256), gmma_step(db, ks * 256), ks > 0);
}

// round(p) of a warpgroup's 64x64 scores as the A fragments of the four
// k-steps of 16 columns (packed before any wgmma reads them, so no register
// write sits between the products of one batch)
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&p)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[kk][1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[kk][2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
  }
}

// acc (64 rows x DP) += a . x, where a holds the packed 64x64 scores and x is
// a 64-row core-matrix tile of DP columns read MN-major
template <int DP>
__device__ __forceinline__ void gmma_pv(float (&acc)[DP / 8][4], const uint32_t (&a)[4][4],
                                        const bf16* x) {
  const uint64_t dx = gmma_desc(x, DP * 16, 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<DP, 1>(&acc[0][0], a[kk], gmma_step(dx, kk * 2 * DP * 16), 1);
}

// ROWS rows (n0.. of a head, row stride rs) into a core-matrix tile of DP
// columns, zero past N and past D. VEC 8: 16-byte cp.async that the caller
// waits for (every row 16-byte aligned and D % 8 == 0); VEC 1: scalar loads
// and stores.
template <int ROWS, int DP, int VEC>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base, long long rs, int n0, int N,
                                          int D) {
  constexpr int kChunks = DP / VEC;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kWgThreads) {
    const int r = idx / kChunks;
    const int d = (idx - r * kChunks) * VEC;
    const int n = n0 + r;
    const bool in = n < N && d < D;
    if constexpr (VEC == 8) {
      cp_async16(dst + cm_off<DP>(r, d), in ? base + n * rs + d : base, in ? 16 : 0);
    } else {
      dst[cm_off<DP>(r, d)] = in ? base[n * rs + d] : __float2bfloat16(0.f);
    }
  }
}

}  // namespace

#endif  // VAVAE_WGMMA_COMMON_CUH
