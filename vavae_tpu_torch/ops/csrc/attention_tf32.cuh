// fp32 attention on Hopper's tensor cores (sm_90a) at fp32 accuracy: the
// forward body (attn_fwd_tf32_kernel) that nat_attention_fwd.cu (replaces
// _nat_fwd_kernel) and attn_small_fwd.cu (replaces _attn_kernel_small_rope
// and _attn_kernel_small) launch for every fp32 call with an even D <= 128,
// and the backward body (attn_bwd_tf32_kernel) that nat_attention_bwd.cu
// (replaces _nat_bwd_kernel) and attn_small_bwd.cu (replaces
// _attn_bwd_kernel_small) launch for every fp32 call (the backward takes D <=
// 128 only). The fp32 forward calls these bodies do not take, D in (128, 256]
// and flash_fwd.cu's all-fp32 long-route pair, stay on the FMA body of
// attention_fwd.cuh. Each is chosen by shape alone.
//
// Numerics: the first fp32 bodies' and the TPU kernels' (attention_fwd.cuh,
// attention_bwd.cuh), with nothing rounded to a narrower type (rounding to
// the input dtype is no rounding at fp32):
//   q~, k~ = x*cos + roll(x, D/2)*sin'   fp32, fp32 tables (sin' sign-folded)
//   s = (q~ . k~^T) * D^-0.5, p = exp(s - rowmax), o = (P . V) / rowsum(p)
//   backward: P normalised, dv = P^T . g, dP = g . v^T,
//   dS = P o (dP - rowsum(dP o P)) * D^-0.5, dq = dS . k~, dk = dS^T . q~,
//   dq, dk <- the transposed RoPE x*cos + roll(x*sin', D/2)
// with the forward's softmax one-pass online over 64-key tiles.
//
// 3xTF32. The TF32 tensor cores read 10 of an fp32 operand's 23 mantissa
// bits: one TF32 pass is 2^-11 (4.9e-4) from fp32, over the kernels' limits
// (forward 1e-5 max-abs, backward 1e-4 of max|ref|). So every product, S =
// q~.k~^T, P.V, dP = g.v^T, dv = P^T.g, dq = dS.k~ and dk = dS^T.q~ (P and dS
// unrounded), runs as three: each operand element x split as hi = x rounded
// to TF32 (cvt.rna's rounding, in integer operations) and lo = cvt.rna.tf32(x
// - hi), formed explicitly (the tensor cores would truncate x, not split it),
// and a.b taken as lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b), the small terms
// first, fp32 accumulation (split_tf32, mma_3xtf32). The dropped lo(a).lo(b)
// and lo's own rounding leave about 2^-21 of |a||b| a term.
//
// Bound on an H100 SXM (3.35 TB/s; TF32 495 TFLOP/s, so three TF32 products
// of 2*M*N*K each) at the micro-Doppler DiT-S/2's LoRA shape (B=16, H=6,
// N=64, D=64, RoPE): forward 4 fp32 (B, N, H, D) tensors and the two (N, D)
// tables, 6.32 MB -> 1.89 us, against 3 * 4*B*H*N^2*D = 0.30 GFLOP -> 0.61
// us; backward 7 tensors, 11.04 MB -> 3.30 us, against 3 * 10*B*H*N^2*D =
// 0.75 GFLOP -> 1.53 us: the bytes bound both (at B=32: 3.77 and 6.58 us).
//
// Why mma.sync m16n8k8 (TF32 in, fp32 accumulate) and not wgmma. TF32 wgmma
// takes both shared-memory operands K-major (no transpose), and the tensor
// cores read only the TF32 bits of what is stored, so 3xTF32 on wgmma keeps a
// hi and a lo copy of every shared operand, and K-major copies of v, g, q~
// and k~ for the products that contract over rows (P.V, dv, dk, dq): the
// backward of one 64-row tile needs at least six such operands beside P and
// dS held in registers, 192 KB at D = 64 and 384 KB at D = 128, against the
// 227 KB a block may use. mma.sync takes both operands from registers: each
// tile is stored once, in fp32, read in whichever orientation a product
// needs, and split in registers; and its 16-row warp tiles let a 64-row
// head spread over 8 or 16 warps.
//
// Design. At N = 64 (every path that runs these bodies: the micro-Doppler
// DiTs, 6 or 12 heads of 64) a head is one tile, and the work of a head is
// a few microseconds of dependent steps; the design spreads each head over
// many warps and keeps every step in shared memory.
//  - Tiles are fp32 rows of DP + 4 floats (DP = D zero-padded to 32, 64, 72
//    or 128), so that the eight row groups of a fragment load fall on
//    distinct banks; they arrive by 16-byte cp.async when every input row
//    (and with RoPE each table) is 16-byte aligned, else by scalar loads.
//    The tables' rows of a tile arrive with it, so RoPE is a pass over
//    shared memory.
//  - Fragments (mma_m16n8k8_tf32): A (g, c), (g + 8, c), (g, c + 4), (g + 8, c
//    + 4), B (c, g), (c + 4, g), the accumulator (g, 2c), (g, 2c + 1), (g + 8,
//    ..). A product whose A operand is an accumulator (P.V) or that reads a
//    tile across its rows (dv, dk, dq) takes the k-steps' columns in the
//    order 2c, 2c + 1 (the accumulator's), and reads B's rows in the same
//    order: the score registers are the A fragments as they stand, and the
//    column reads of a tile (rows 2c, 2c + 1 of 8) fall on distinct banks.
//  - Forward: a block of eight warps owns 32 queries of one (batch, head);
//    warp (qg, kg) takes queries 16qg.. against keys 16kg.. of every 64-key
//    tile with its own online softmax (P stays in registers), and the four
//    key groups' partial outputs are merged through shared memory at the
//    end. The k~, v tiles and their table rows stream through a ring of two
//    stages (one when the head is one tile), the next tile in flight under
//    this one's products, starting from the tile that holds the block's
//    queries, whose table rows rotate q. Grid (N/32, H, B): 192 blocks at
//    (16, 6, 64, 64), 96 at (4, 12, 64, 64); 74.5 KB of shared memory and
//    124 registers at DP = 64, two blocks an SM (264 slots on 132 SMs).
//  - Backward: a block owns one (batch, head), so nothing leaves it but the
//    gradients: no atomics, every sum in a fixed order, and a second call
//    gives bit-identical results. Warp (rg, cg) takes rows 16rg.. of each
//    product and column group cg. At N <= 64 (16 warps, 512 threads) q, k,
//    v, g and the tables' rows are read once, q~ and k~ rotated once; S and
//    dP are formed once, the row statistics merged across the four column
//    groups in shared memory, P and dS written there, then dq, dv and dk:
//    five products, one launch, no scratch. The tables share P and dS's
//    space (loaded again for the epilogue's transposed RoPE), so at DP = 64
//    a block takes 105 KB and at most 64 registers a thread: two blocks an
//    SM, 96 blocks at (16, 6, 64, 64), 192 at (32, 6, 64, 64). Longer heads
//    (8 warps) rotate q~, k~ once into the scratch, take the statistics in a
//    first stream (S, dP), then walk key tiles, each over every query tile:
//    seven products a tile pair where the first body ran nine, dq summed
//    over the key tiles in the scratch in key order.
//  What holds them (chip_smoke.py phase 3, PERF.md): each operand element
//  is loaded and split in registers by every warp that reads it, and the
//  lo parts go through the conversion unit, a quarter of the integer rate;
//  RoPE's table rows are read by each block. Not done: a grid over key
//  tiles for heads longer than 64 rows (no path runs one in fp32), operands
//  split once into hi and lo copies in shared memory, TMA.

#ifndef VAVAE_ATTENTION_TF32_CUH
#define VAVAE_ATTENTION_TF32_CUH

#include "attention_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kTf32Tile = 64;     // keys of a streamed tile; rows of a backward tile
constexpr int kTf32Groups = 4;    // 16-row groups of a tile
constexpr int kTf32FwdQGroups = 2;                  // a forward block's 16-query groups
constexpr int kTf32FwdRows = 16 * kTf32FwdQGroups;  // queries a forward block owns
// a forward block: one warp per (query group, 16-key group of each tile)
constexpr int kTf32FwdWarps = kTf32FwdQGroups * kTf32Groups;
constexpr int kTf32FwdThreads = 32 * kTf32FwdWarps;
// a backward block: one warp per (16-row group, column group) of each
// product; four column groups when the head is one tile (no scratch, so the
// registers of 16 warps suffice), two for longer heads
template <bool SINGLE>
__host__ __device__ constexpr int tf32_bwd_cols() { return SINGLE ? 4 : 2; }
template <bool SINGLE>
__host__ __device__ constexpr int tf32_bwd_threads() { return 32 * kTf32Groups * tf32_bwd_cols<SINGLE>(); }
constexpr int kTf32Ldp = kTf32Tile + 4;  // row stride of the backward's P and dS tiles

// the head dim zero-padded to the fp32 bodies' product depth (k-steps of 8)
inline int tf32_padded_dim(int D) { return D <= 32 ? 32 : D <= 64 ? 64 : D <= 72 ? 72 : 128; }

// ring stages of the forward's k~, v tiles: two up to DP = 72, one at DP =
// 128 (where two stages with their tables exceed a block's shared memory);
// a call whose head is one tile takes one
template <int DP>
constexpr int tf32_fwd_stages() { return DP <= 72 ? 2 : 1; }

// floats of a forward ring stage: a k~ and a v tile, then with RoPE the
// tile's rows of the cos and sin tables (D floats a row)
template <int DP>
__host__ __device__ constexpr int tf32_fwd_stage(int D, bool rope) {
  return 2 * kTf32Tile * (DP + 4) + (rope ? 2 * kTf32Tile * D : 0);
}

// floats of the forward's merge of the key groups, over q~ and the ring
// once the tiles are done: each warp's partial output (16 x DP + 4), its
// rows' m and l, each row's factors
template <int DP>
__host__ __device__ constexpr int tf32_fwd_merge() {
  return kTf32FwdWarps * 16 * (DP + 4 + 2) + kTf32FwdRows * kTf32Groups;
}

// the backward keeps a tile's table rows in shared memory up to DP = 72
// (DP = 128 reads them from device memory: its tiles fill the block's
// allowance); for a one-tile head up to DP = 64 they share the P and dS
// tiles' space, loaded there again for the epilogue, so that two blocks fit
// an SM
template <int DP>
__host__ __device__ constexpr bool tf32_bwd_tables() { return DP <= 72; }
template <int DP, bool SINGLE>
__host__ __device__ constexpr bool tf32_bwd_tables_in_p() { return SINGLE && DP <= 64; }

// floats of the backward's shared memory: q~, k~, v, g; P, dS; the row
// reductions across column groups; a longer head's query tile's m, 1/l,
// delta; the tables' rows, where they do not share P and dS's space
template <int DP, bool SINGLE>
__host__ __device__ constexpr int tf32_bwd_smem_floats() {
  return 4 * kTf32Tile * (DP + 4) + 2 * kTf32Tile * kTf32Ldp +
         3 * tf32_bwd_cols<SINGLE>() * kTf32Tile + (SINGLE ? 0 : 3 * kTf32Tile) +
         (tf32_bwd_tables<DP>() && !tf32_bwd_tables_in_p<DP, SINGLE>() ? 2 * kTf32Tile * DP : 0);
}

// ROWS rows (n0.. of a head, row stride rs) of fp32 into a row-major tile of
// row stride DP + 4, zero past N and past D. VEC 4: 16-byte cp.async (every
// row 16-byte aligned, D % 4 == 0) that the caller waits for; VEC 1: scalar
// loads and stores.
template <int ROWS, int DP, int VEC, int NTHREADS>
__device__ __forceinline__ void load_rows_f32(float* dst, const float* base, long long rs, int n0,
                                              int N, int D) {
  constexpr int LD = DP + 4;
  constexpr int kChunks = DP / VEC;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += NTHREADS) {
    const int r = idx / kChunks;
    const int d = (idx - r * kChunks) * VEC;
    const int n = n0 + r;
    const bool in = n < N && d < D;
    if constexpr (VEC == 4) {
      cp_async16(dst + r * LD + d, in ? base + n * rs + d : base, in ? 16 : 0);
    } else {
      dst[r * LD + d] = in ? base[n * rs + d] : 0.f;
    }
  }
}

// Rows n0.. (at most ROWS, none past N) of the (N, D) cos and sin tables
// into cos_s and sin_s, D floats a row: one contiguous block each. VEC 4:
// 16-byte cp.async (D % 4 == 0, tables 16-byte aligned); VEC 1: scalar.
template <int ROWS, int VEC, int NTHREADS>
__device__ __forceinline__ void load_table_rows(float* cos_s, float* sin_s, const float* cos_t,
                                                const float* sin_t, int n0, int N, int D) {
  const int count = (N - n0 < ROWS ? N - n0 : ROWS) * D;
  const long long at = (long long)n0 * D;
  for (int i = threadIdx.x * VEC; i < count; i += NTHREADS * VEC) {
    if constexpr (VEC == 4) {
      cp_async16(cos_s + i, cos_t + at + i, 16);
      cp_async16(sin_s + i, sin_t + at + i, 16);
    } else {
      cos_s[i] = cos_t[at + i];
      sin_s[i] = sin_t[at + i];
    }
  }
}

// Split-half RoPE in fp32, in place on the first `rows` rows of a tile from
// load_rows_f32: x*cos + roll(x, D/2)*sin', sin' being the split-half table
// negated for d < D/2 (kRawSin: the table as the model holds it, the
// forward's) or the sign-folded table as given (the backward's). ct, st:
// the tables' rows of the tile's first row, D floats a row (shared or
// device memory). An item owns the pair (d, d + D/2): it reads both before
// it writes.
template <int DP, int NTHREADS, bool kRawSin>
__device__ __forceinline__ void rotate_rows_f32(float* tile, int rows, int D, const float* ct,
                                                const float* st) {
  constexpr int LD = DP + 4;
  const int half = D / 2;
  for (int idx = threadIdx.x; idx < rows * half; idx += NTHREADS) {
    const int r = idx / half;
    const int d = idx - r * half;
    float* row = tile + r * LD;
    const float* c = ct + r * D;
    const float* s = st + r * D;
    const float x = row[d], xr = row[d + half];
    const float s0 = kRawSin ? -s[d] : s[d];
    row[d] = x * c[d] + xr * s0;
    row[d + half] = xr * c[d + half] + x * s[d + half];
  }
}

// K fragment values, each split into its TF32 hi and lo parts
template <int K>
__device__ __forceinline__ void split_frag(const float (&x)[K], uint32_t (&hi)[K],
                                           uint32_t (&lo)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) split_tf32(x[i], hi[i], lo[i]);
}

// acc (16 rows x 8*NJ columns) += a . b^T over DP columns at fp32 accuracy:
// a the warp's 16 rows of a tile of stride LDA, b NJ*8 rows of a tile of
// stride LDB (the scores S = q~.k~^T and dP = g.v^T)
template <int DP, int NJ, int LDA, int LDB>
__device__ __forceinline__ void mma_rows_dot(float (&acc)[NJ][4], const float* a, const float* b,
                                             int gr, int cq) {
#pragma unroll 2
  for (int ks = 0; ks < DP / 8; ++ks) {
    const float* ar = a + gr * LDA + ks * 8 + cq;
    const float x[4] = {ar[0], ar[8 * LDA], ar[4], ar[8 * LDA + 4]};
    uint32_t ah[4], al[4];
    split_frag(x, ah, al);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* br = b + (j * 8 + gr) * LDB + ks * 8 + cq;
      const float y[2] = {br[0], br[4]};
      uint32_t bh[2], bl[2];
      split_frag(y, bh, bl);
      mma_3xtf32(acc[j], ah, al, bh, bl);
    }
  }
}

// acc (16 rows x the 8-column groups u0 .. u0 + NTW - 1 below NT of X) +=
// A . X over 8*KK rows of X (stride LDX): a_frag(kk, x) gives k-step kk's A
// fragment with A's columns 8kk + 2c, 8kk + 2c + 1 at the fragment's columns
// c, c + 4 (the accumulator's order), so X's rows are read in that order
template <int KK, int NTW, int NT, int LDX, class AFrag>
__device__ __forceinline__ void mma_pairs_x(float (&acc)[NTW][4], AFrag a_frag, const float* xs,
                                            int u0, int gr, int cq) {
#pragma unroll 2
  for (int kk = 0; kk < KK; ++kk) {
    float x[4];
    a_frag(kk, x);
    uint32_t ah[4], al[4];
    split_frag(x, ah, al);
    const float* xr = xs + (kk * 8 + 2 * cq) * LDX + gr;
#pragma unroll
    for (int uu = 0; uu < NTW; ++uu) {
      const int u = u0 + uu;
      if (NTW == NT || u < NT) {  // uniform across the warp
        const float y[2] = {xr[u * 8], xr[LDX + u * 8]};
        uint32_t bh[2], bl[2];
        split_frag(y, bh, bl);
        mma_3xtf32(acc[uu], ah, al, bh, bl);
      }
    }
  }
}

// The forward for 32 queries of one (batch, head): DP = the head dim
// zero-padded (32, 64, 72 or 128); VEC as in load_rows_f32 (with RoPE, 4 also
// needs both tables 16-byte aligned); scale = D^-0.5; cos, sin: the
// split-half tables as the model holds them, read when use_rope; stages: the
// ring's stages (1 when the head is one tile). Warp (qg, kg) takes the
// block's queries 16qg.. against keys 16kg.. of every tile, with its own
// online softmax; the four key groups' partial outputs are merged at the end.
// The key tiles are taken from the one that holds the block's queries on, so
// that q is rotated with that tile's table rows.
template <int DP, int VEC>
__global__ void __launch_bounds__(kTf32FwdThreads)
attn_fwd_tf32_kernel(View q, View k, View v, View out, const float* __restrict__ cos_t,
                     const float* __restrict__ sin_t, int N, int D, float scale, int use_rope,
                     int stages) {
  constexpr int LD = DP + 4;
  constexpr int NT = DP / 8;              // 8-column groups of the output
  constexpr int kTile = kTf32Tile * LD;   // floats of a k~ or v tile
  constexpr int T = kTf32FwdThreads;
  extern __shared__ float smem[];
  const bool rope = use_rope != 0;
  const int stage_f = tf32_fwd_stage<DP>(D, rope);
  float* q_s = smem;                      // kTf32FwdRows x LD: q~
  float* ring = q_s + kTf32FwdRows * LD;  // stages of k~, v and the tables' rows

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;  // fragment row group
  const int cq = lane % 4;  // fragment column
  const int qg = warp % kTf32FwdQGroups;  // the warp's 16 queries
  const int kg = warp / kTf32FwdQGroups;  // its 16 keys of each tile
  const int q0 = blockIdx.x * kTf32FwdRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = (N + kTf32Tile - 1) / kTf32Tile;
  const int first = q0 / kTf32Tile;  // the key tile that holds the block's queries
  const float* __restrict__ qb = head_base<const float>(q, b, h);
  const float* __restrict__ kb = head_base<const float>(k, b, h);
  const float* __restrict__ vb = head_base<const float>(v, b, h);

  // the i-th key tile, its stage, and its loads (one cp.async group a call)
  auto tile_of = [&](int i) { return (first + i) % tiles; };
  auto stage = [&](int i) { return ring + (i % stages) * stage_f; };
  auto load_tile = [&](int i) {
    if (i < tiles) {
      float* st = stage(i);
      const int n0 = tile_of(i) * kTf32Tile;
      load_rows_f32<kTf32Tile, DP, VEC, T>(st, kb, k.sn, n0, N, D);
      load_rows_f32<kTf32Tile, DP, VEC, T>(st + kTile, vb, v.sn, n0, N, D);
      if (rope)
        load_table_rows<kTf32Tile, VEC, T>(st + 2 * kTile, st + 2 * kTile + kTf32Tile * D, cos_t,
                                           sin_t, n0, N, D);
    }
    cp_async_commit();
  };
  load_rows_f32<kTf32FwdRows, DP, VEC, T>(q_s, qb, q.sn, q0, N, D);
  load_tile(0);  // q lands with the first tile

  float o[NT][4];
#pragma unroll
  for (int u = 0; u < NT; ++u) o[u][0] = o[u][1] = o[u][2] = o[u][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of the lane's rows gr and gr + 8
  float l0 = 0.f, l1 = 0.f;              // running sums
  const float* q_w = q_s + qg * 16 * LD;  // this warp's 16 queries
  for (int i = 0; i < tiles; ++i) {
    if (stages > 1) {
      load_tile(i + 1);  // into tile i - 1's stage, which the barrier ending tile i - 1 freed
    } else {
      cp_async_commit();  // (tile i was loaded at the end of tile i - 1)
    }
    cp_async_wait<1>();  // this thread's copies of q and tile i have landed
    __syncthreads();
    float* k_s = stage(i);
    const float* v_s = k_s + kTile;
    const int k0 = tile_of(i) * kTf32Tile;
    if (rope) {
      const float* ct = k_s + 2 * kTile;
      const float* st = ct + kTf32Tile * D;
      if (i == 0) {
        const int r0 = q0 - k0;  // the queries' first row in the tile's tables
        rotate_rows_f32<DP, T, true>(q_s, N - q0 < kTf32FwdRows ? N - q0 : kTf32FwdRows, D,
                                     ct + r0 * D, st + r0 * D);
      }
      rotate_rows_f32<DP, T, true>(k_s, N - k0 < kTf32Tile ? N - k0 : kTf32Tile, D, ct, st);
      __syncthreads();
    }

    // s = q~ . k~^T: the warp's 16 queries x its 16 keys of the tile
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_rows_dot<DP, 2, LD, LD>(s, q_w, k_s + kg * 16 * LD, gr, cq);

    // scale, mask keys past N, online softmax over the four lanes of a row;
    // a warp none of whose keys so far is below N keeps p = 0
    const int kw0 = k0 + kg * 16;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool valid = kw0 + j * 8 + 2 * cq + (e & 1) < N;
        s[j][e] = valid ? s[j][e] * scale : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float base0 = mn0 == -INFINITY ? 0.f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.f : mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[j][0] = expf(s[j][0] - base0);
      s[j][1] = expf(s[j][1] - base0);
      s[j][2] = expf(s[j][2] - base1);
      s[j][3] = expf(s[j][3] - base1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float alpha0 = expf(m0 - base0);
    const float alpha1 = expf(m1 - base1);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      o[u][0] *= alpha0;
      o[u][1] *= alpha0;
      o[u][2] *= alpha1;
      o[u][3] *= alpha1;
    }

    // o += P . V over the warp's 16 keys, P's A fragments the score
    // registers as they stand
    mma_pairs_x<2, NT, NT, LD>(o, [&](int kk, float (&x)[4]) {
      x[0] = s[kk][0];
      x[1] = s[kk][2];
      x[2] = s[kk][1];
      x[3] = s[kk][3];
    }, v_s + kg * 16 * LD, 0, gr, cq);
    __syncthreads();  // every warp is done with tile i's stage before a later tile loads into it
    if (stages == 1) load_tile(i + 1);
  }

  // merge the key groups over q~ and the ring (free now): warp w's partial
  // output (16 x DP), its rows' m and l, then o = sum_g o_g e^(m_g - m) /
  // sum_g l_g e^(m_g - m) with m = max_g m_g, a row's factors computed once
  float* parts = smem;                               // [warp][16 rows][LD]
  float* part = parts + warp * 16 * LD;
  float* ml = parts + kTf32FwdWarps * 16 * LD;       // [warp][16 rows][m, l]
  float* fac = ml + kTf32FwdWarps * 16 * 2;          // [rows][key group]
#pragma unroll
  for (int half_row = 0; half_row < 2; ++half_row) {
    float* row = part + (gr + 8 * half_row) * LD + 2 * cq;
#pragma unroll
    for (int u = 0; u < NT; ++u) store_pair(row + u * 8, o[u][2 * half_row], o[u][2 * half_row + 1]);
    if (cq == 0)
      store_pair(ml + (warp * 16 + gr + 8 * half_row) * 2, half_row ? m1 : m0, half_row ? l1 : l0);
  }
  __syncthreads();
  if (threadIdx.x < kTf32FwdRows) {
    const int r = threadIdx.x, g0 = r / 16, rr = r % 16;
    float m = -INFINITY;
#pragma unroll
    for (int g = 0; g < kTf32Groups; ++g)
      m = fmaxf(m, ml[((g * kTf32FwdQGroups + g0) * 16 + rr) * 2]);
    float l = 0.f, f[kTf32Groups];
#pragma unroll
    for (int g = 0; g < kTf32Groups; ++g) {
      const float* x = ml + ((g * kTf32FwdQGroups + g0) * 16 + rr) * 2;
      f[g] = expf(x[0] - m);  // 0 for a group with no key below N
      l += x[1] * f[g];
    }
#pragma unroll
    for (int g = 0; g < kTf32Groups; ++g) fac[r * kTf32Groups + g] = f[g] / l;
  }
  __syncthreads();
  float* ob = head_base<float>(out, b, h);
  for (int idx = threadIdx.x; idx < kTf32FwdRows * D; idx += T) {
    const int r = idx / D, d = idx - r * D;
    const int n = q0 + r;
    if (n >= N) continue;
    const int g0 = r / 16, rr = r % 16;
    float x = 0.f;
#pragma unroll
    for (int g = 0; g < kTf32Groups; ++g)
      x += parts[((g * kTf32FwdQGroups + g0) * 16 + rr) * LD + d] * fac[r * kTf32Groups + g];
    ob[n * out.sn + d] = x;
  }
}

// Writes a (64, D) fp32 tile (stride ld: shared memory, or the backward's dq
// sum in the scratch) to rows n0.. of a gradient head (row stride
// row_stride), with the transposed RoPE x*cos + roll(x*sin', D/2) in fp32
// when rotate is set (sin' sign-folded; ct, st: the tables' rows of row n0,
// D floats a row).
template <int NTHREADS>
__device__ void store_rows(float* out_base, long long row_stride, const float* tile, int ld,
                           int n0, int N, int D, bool rotate, const float* ct, const float* st) {
  const int half = D / 2;
  for (int idx = threadIdx.x; idx < kTf32Tile * D; idx += NTHREADS) {
    const int r = idx / D;
    const int d = idx - r * D;
    const int n = n0 + r;
    if (n >= N) continue;
    float val = tile[r * ld + d];
    if (rotate) {
      const int p = rope_partner(d, half);
      val = val * ct[r * D + d] + tile[r * ld + p] * st[r * D + p];
    }
    out_base[n * row_stride + d] = val;
  }
}

// The backward for one (batch, head): DP = the head dim zero-padded; VEC 4
// when q, k, v and g all have 16-byte aligned rows (and, with RoPE, both
// tables are 16-byte aligned); SINGLE: N <= 64, the head one tile; cos, sin:
// (N, D) with sin sign-folded, read when use_rope. Warp (rg, cg) takes rows
// 16rg.. of each product and its column group cg: keys KW*cg.. of S and dP,
// the cg-th share of the 8-column groups of dv, dk and dq. Heads longer than
// one tile use the head's rows of the scratch: qt, kt (q~, k~ rotated, N x
// DP), dqa (dq's sum over key tiles, N x DP) and st (m, 1/l, delta, 3 x N).
template <int DP, int VEC, bool SINGLE>
__global__ void __launch_bounds__(tf32_bwd_threads<SINGLE>(),
                                  tf32_bwd_tables_in_p<DP, SINGLE>() ? 2 : 1)
attn_bwd_tf32_kernel(View q, View k, View v, View g, View dq, View dk, View dv,
                     const float* __restrict__ cos_t, const float* __restrict__ sin_t,
                     float* __restrict__ qt, float* __restrict__ kt, float* __restrict__ dqa,
                     float* __restrict__ st, int N, int H, int D, float scale, int use_rope) {
  constexpr int LD = DP + 4;
  constexpr int LDP = kTf32Ldp;
  constexpr int COLS = tf32_bwd_cols<SINGLE>();
  constexpr int NT = DP / 8;                      // 8-column groups of dq, dk, dv
  constexpr int NTW = (NT + COLS - 1) / COLS;     // a warp's share of them
  constexpr int KW = kTf32Tile / COLS;            // a warp's keys of S and dP
  constexpr int NJ = KW / 8;
  constexpr int kTile = kTf32Tile * LD;  // floats of a q~, k~, v or g tile
  constexpr int T = tf32_bwd_threads<SINGLE>();
  extern __shared__ float smem[];
  float* q_s = smem;                      // q~ of the query tile (then dk of the key tile)
  float* k_s = q_s + kTile;               // k~ of the key tile
  float* v_s = k_s + kTile;               // v of the key tile (then dq of a single tile)
  float* g_s = v_s + kTile;               // g of the query tile
  float* p_s = g_s + kTile;               // P (queries x keys), stride LDP
  float* ds_s = p_s + kTf32Tile * LDP;    // dS
  float* red = ds_s + kTf32Tile * LDP;    // row reductions: [3][column group][64 rows]
  float* st_s = red + 3 * COLS * kTf32Tile;  // a longer head's query tile's m, 1/l, delta
  constexpr bool kTablesInP = tf32_bwd_tables_in_p<DP, SINGLE>();
  float* tab_s = kTablesInP ? p_s : st_s + (SINGLE ? 0 : 3 * kTf32Tile);  // a tile's cos, sin rows

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gr = lane / 4;
  const int cq = lane % 4;
  const int rg = warp % kTf32Groups;  // the warp's 16 rows of each product
  const int cg = warp / kTf32Groups;  // its column group
  const int u0 = cg * NTW;            // its first 8-column group of dv, dk, dq
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tiles = SINGLE ? 1 : (N + kTf32Tile - 1) / kTf32Tile;
  constexpr bool single = SINGLE;  // the whole head in one tile: no scratch
  const bool rope = use_rope != 0;
  // a tile's table rows come into shared memory with the tile (up to DP = 72)
  const bool staged = rope && tf32_bwd_tables<DP>();
  const float* ct = staged ? tab_s : cos_t;
  const float* stb = staged ? tab_s + kTf32Tile * D : sin_t;
  const long long head = (long long)b * H + h;
  const float* __restrict__ qb = head_base<const float>(q, b, h);
  const float* __restrict__ kb = head_base<const float>(k, b, h);
  const float* __restrict__ vb = head_base<const float>(v, b, h);
  const float* __restrict__ gb = head_base<const float>(g, b, h);
  float* qt_h = qt + head * N * DP;
  float* kt_h = kt + head * N * DP;
  float* dqa_h = dqa + head * N * DP;
  float* st_h = st + head * 3 * N;
  const int r_lo = rg * 16 + gr;  // the lane's rows r_lo and r_lo + 8 of the tile

  // query tile i's q~ and g, key tile j's k~ and v: q~, k~ from the inputs
  // (a single tile, rotated once they land) or from the rotated scratch
  auto load_query = [&](int i) {
    if constexpr (single) {
      load_rows_f32<kTf32Tile, DP, VEC, T>(q_s, qb, q.sn, 0, N, D);
    } else {
      load_rows_f32<kTf32Tile, DP, 4, T>(q_s, qt_h, DP, i * kTf32Tile, N, DP);
    }
    load_rows_f32<kTf32Tile, DP, VEC, T>(g_s, gb, g.sn, i * kTf32Tile, N, D);
  };
  auto load_key = [&](int j) {
    if constexpr (single) {
      load_rows_f32<kTf32Tile, DP, VEC, T>(k_s, kb, k.sn, 0, N, D);
    } else {
      load_rows_f32<kTf32Tile, DP, 4, T>(k_s, kt_h, DP, j * kTf32Tile, N, DP);
    }
    load_rows_f32<kTf32Tile, DP, VEC, T>(v_s, vb, v.sn, j * kTf32Tile, N, D);
  };
  // S = q~ . k~^T and dP = g . v^T: the warp's 16 queries x its KW keys
  auto scores = [&](float (&s)[NJ][4], float (&dp)[NJ][4]) {
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mma_rows_dot<DP, NJ, LD, LD>(s, q_s + rg * 16 * LD, k_s + cg * KW * LD, gr, cq);
    mma_rows_dot<DP, NJ, LD, LD>(dp, g_s + rg * 16 * LD, v_s + cg * KW * LD, gr, cq);
  };
  // a per-row value of the lane's rows (x[0]: r_lo, x[1]: r_lo + 8), reduced
  // over the four lanes of a row, into column group cg's slot of reduction
  // `which`; read back with `gathered` after a barrier
  auto quad_sum = [&](float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
  };
  auto quad_max = [&](float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  };
  auto scatter = [&](int which, const float (&x)[2]) {
    if (cq == 0) {
      red[(which * COLS + cg) * kTf32Tile + r_lo] = x[0];
      red[(which * COLS + cg) * kTf32Tile + r_lo + 8] = x[1];
    }
  };
  auto slot = [&](int which, int group, int half_row) {
    return red[(which * COLS + group) * kTf32Tile + r_lo + 8 * half_row];
  };

  if constexpr (!single) {
    // q~ and k~ rotated once per row into the scratch, a tile at a time
    // through shared memory (with the tile's table rows), zero past D
    constexpr int kChunks = DP / 4;
    for (int t = 0; t < tiles; ++t) {
      const int n0 = t * kTf32Tile;
      load_rows_f32<kTf32Tile, DP, VEC, T>(q_s, qb, q.sn, n0, N, D);
      load_rows_f32<kTf32Tile, DP, VEC, T>(k_s, kb, k.sn, n0, N, D);
      if (staged)
        load_table_rows<kTf32Tile, VEC, T>(tab_s, tab_s + kTf32Tile * D, cos_t, sin_t, n0, N, D);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (rope) {
        const long long trow = staged ? 0 : (long long)n0 * D;
        const int rows = N - n0 < kTf32Tile ? N - n0 : kTf32Tile;
        rotate_rows_f32<DP, T, false>(q_s, rows, D, ct + trow, stb + trow);
        rotate_rows_f32<DP, T, false>(k_s, rows, D, ct + trow, stb + trow);
        __syncthreads();
      }
      for (int idx = threadIdx.x; idx < 2 * kTf32Tile * kChunks; idx += T) {
        const int which = idx / (kTf32Tile * kChunks);  // 0: q, 1: k
        const int r = (idx / kChunks) % kTf32Tile;
        const int c = (idx % kChunks) * 4;
        if (n0 + r < N)
          *reinterpret_cast<float4*>((which ? kt_h : qt_h) + (long long)(n0 + r) * DP + c) =
              *reinterpret_cast<const float4*>((which ? k_s : q_s) + r * LD + c);
      }
      __syncthreads();  // before the next tile's loads
    }
    __threadfence();
    __syncthreads();  // the block's rotated rows are visible to its copies below

    // the row statistics: one stream of the key tiles per query tile, S and
    // dP once a pair; each warp keeps the online max m, sum l and sum of
    // exp(s - m) * dP over its keys, merged across column groups at the end
    for (int i = 0; i < tiles; ++i) {
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, e[2] = {0.f, 0.f};
      for (int j = 0; j < tiles; ++j) {
        if (j == 0) load_query(i);
        load_key(j);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        float s[NJ][4], dp[NJ][4];
        scores(s, dp);
        const int kw0 = j * kTf32Tile + cg * KW;
#pragma unroll
        for (int half_row = 0; half_row < 2; ++half_row) {
          float mx = -INFINITY;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int ee = 2 * half_row; ee < 2 * half_row + 2; ++ee) {
              const bool valid = kw0 + jj * 8 + 2 * cq + (ee & 1) < N;
              s[jj][ee] = valid ? s[jj][ee] * scale : -INFINITY;
              mx = fmaxf(mx, s[jj][ee]);
            }
          const float mn = fmaxf(m[half_row], quad_max(mx));
          const float base = mn == -INFINITY ? 0.f : mn;  // no key below N yet
          float sum = 0.f, dsum = 0.f;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int ee = 2 * half_row; ee < 2 * half_row + 2; ++ee) {
              const float x = expf(s[jj][ee] - base);
              sum += x;
              dsum += x * dp[jj][ee];
            }
          const float alpha = expf(m[half_row] - base);
          l[half_row] = l[half_row] * alpha + quad_sum(sum);
          e[half_row] = e[half_row] * alpha + quad_sum(dsum);
          m[half_row] = mn;
        }
        __syncthreads();  // every warp is done with the tiles before the next loads
      }
      scatter(0, m);
      scatter(1, l);
      scatter(2, e);
      __syncthreads();
      if (cg == 0 && cq == 0) {
#pragma unroll
        for (int half_row = 0; half_row < 2; ++half_row) {
          const int n = i * kTf32Tile + r_lo + 8 * half_row;
          float mm = -INFINITY, ll = 0.f, ee = 0.f;
#pragma unroll
          for (int grp = 0; grp < COLS; ++grp) mm = fmaxf(mm, slot(0, grp, half_row));
#pragma unroll
          for (int grp = 0; grp < COLS; ++grp) {
            const float f = expf(slot(0, grp, half_row) - mm);  // 0 for a group with no key
            ll += slot(1, grp, half_row) * f;
            ee += slot(2, grp, half_row) * f;
          }
          if (n < N) {
            const float il = 1.0f / ll;
            st_h[n] = mm;
            st_h[N + n] = il;
            st_h[2 * N + n] = ee * il;
          }
        }
      }
      __syncthreads();  // the reductions are read before the next query tile's
    }
  }

  float* dqb = head_base<float>(dq, b, h);
  float* dkb = head_base<float>(dk, b, h);
  float* dvb = head_base<float>(dv, b, h);
  for (int j = 0; j < tiles; ++j) {
    float dv_acc[NTW][4], dk_acc[NTW][4];
#pragma unroll
    for (int u = 0; u < NTW; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_acc[u][e] = dk_acc[u][e] = 0.f;
    const int k0 = j * kTf32Tile;
    for (int i = 0; i < tiles; ++i) {
      const int q0 = i * kTf32Tile;
      if (i == 0) load_key(j);  // k~ and v stay over the query tiles
      load_query(i);
      if (single && staged)
        load_table_rows<kTf32Tile, VEC, T>(tab_s, tab_s + kTf32Tile * D, cos_t, sin_t, 0, N, D);
      cp_async_commit();
      if constexpr (!single) {
        for (int c = threadIdx.x; c < 3 * kTf32Tile; c += T) {
          const int n = q0 + c % kTf32Tile;
          st_s[c] = n < N ? st_h[(c / kTf32Tile) * N + n] : 0.f;
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (single && rope) {
        rotate_rows_f32<DP, T, false>(q_s, N, D, ct, stb);
        rotate_rows_f32<DP, T, false>(k_s, N, D, ct, stb);
        __syncthreads();
      }

      float s[NJ][4], dp[NJ][4];
      scores(s, dp);
      // the lane's rows' statistics: a single tile's from the scores, merged
      // across the column groups in shared memory; else from the first stream
      float mr[2], ilr[2], dlr[2];
      const int kw0 = k0 + cg * KW;
      if constexpr (single) {
        float x[2];
#pragma unroll
        for (int half_row = 0; half_row < 2; ++half_row) {
          float mx = -INFINITY;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int ee = 2 * half_row; ee < 2 * half_row + 2; ++ee) {
              const bool valid = kw0 + jj * 8 + 2 * cq + (ee & 1) < N;
              s[jj][ee] = valid ? s[jj][ee] * scale : -INFINITY;
              mx = fmaxf(mx, s[jj][ee]);
            }
          x[half_row] = quad_max(mx);
        }
        scatter(0, x);
        __syncthreads();
        float y[2], z[2];
#pragma unroll
        for (int half_row = 0; half_row < 2; ++half_row) {
          float mx = -INFINITY;
#pragma unroll
          for (int grp = 0; grp < COLS; ++grp) mx = fmaxf(mx, slot(0, grp, half_row));
          mr[half_row] = mx;
          float sum = 0.f, dsum = 0.f;
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
            for (int ee = 2 * half_row; ee < 2 * half_row + 2; ++ee) {
              const float e = expf(s[jj][ee] - mx);  // 0 past N
              sum += e;
              dsum += e * dp[jj][ee];
            }
          y[half_row] = quad_sum(sum);
          z[half_row] = quad_sum(dsum);
        }
        scatter(1, y);
        scatter(2, z);
        __syncthreads();
#pragma unroll
        for (int half_row = 0; half_row < 2; ++half_row) {
          float sum = 0.f, dsum = 0.f;
#pragma unroll
          for (int grp = 0; grp < COLS; ++grp) {
            sum += slot(1, grp, half_row);
            dsum += slot(2, grp, half_row);
          }
          ilr[half_row] = 1.0f / sum;
          dlr[half_row] = dsum * ilr[half_row];
        }
      } else {
#pragma unroll
        for (int half_row = 0; half_row < 2; ++half_row) {
          const int r = r_lo + 8 * half_row;
          mr[half_row] = st_s[r];
          ilr[half_row] = st_s[kTf32Tile + r];
          dlr[half_row] = st_s[2 * kTf32Tile + r];
        }
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
          for (int ee = 0; ee < 4; ++ee) s[jj][ee] *= scale;
      }
      // P and dS in place (0 for keys or queries past N), into shared memory
#pragma unroll
      for (int half_row = 0; half_row < 2; ++half_row) {
        const int r = r_lo + 8 * half_row;
        const bool qin = q0 + r < N;
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
          for (int ee = 2 * half_row; ee < 2 * half_row + 2; ++ee) {
            const bool in = qin && kw0 + jj * 8 + 2 * cq + (ee & 1) < N;
            const float p = in ? expf(s[jj][ee] - mr[half_row]) * ilr[half_row] : 0.f;
            s[jj][ee] = p;
            dp[jj][ee] = p * (dp[jj][ee] - dlr[half_row]) * scale;
          }
          const int c = cg * KW + jj * 8 + 2 * cq;
          store_pair(p_s + r * LDP + c, s[jj][2 * half_row], s[jj][2 * half_row + 1]);
          store_pair(ds_s + r * LDP + c, dp[jj][2 * half_row], dp[jj][2 * half_row + 1]);
        }
      }
      __syncthreads();  // P and dS are whole; every warp is done with S, dP (and v_s)

      // dq (queries 16rg.., the warp's column groups) = dS . k~ over the
      // tile's 64 keys, dS read along its rows; a single tile's into v_s,
      // free now, a longer head's into its sum over key tiles, in key order
      {
        float dq_acc[NTW][4];
#pragma unroll
        for (int u = 0; u < NTW; ++u) dq_acc[u][0] = dq_acc[u][1] = dq_acc[u][2] = dq_acc[u][3] = 0.f;
        const float* dsr = ds_s + r_lo * LDP + 2 * cq;
        mma_pairs_x<8, NTW, NT, LD>(dq_acc, [&](int kk, float (&x)[4]) {
          x[0] = dsr[kk * 8];
          x[1] = dsr[8 * LDP + kk * 8];
          x[2] = dsr[kk * 8 + 1];
          x[3] = dsr[8 * LDP + kk * 8 + 1];
        }, k_s, u0, gr, cq);
#pragma unroll
        for (int half_row = 0; half_row < 2; ++half_row) {
          const int r = r_lo + 8 * half_row;
#pragma unroll
          for (int uu = 0; uu < NTW; ++uu) {
            const int d = (u0 + uu) * 8 + 2 * cq;
            if (u0 + uu >= NT) continue;
            const float x0 = dq_acc[uu][2 * half_row], x1 = dq_acc[uu][2 * half_row + 1];
            if constexpr (single) {
              store_pair(v_s + r * LD + d, x0, x1);
            } else if (q0 + r < N) {
              float* at = dqa_h + (long long)(q0 + r) * DP + d;
              if (j == 0) {
                store_pair(at, x0, x1);
              } else {
                store_pair(at, at[0] + x0, at[1] + x1);
              }
            }
          }
        }
      }
      // dv += P^T . g and dk += dS^T . q~: keys 16rg.. of tile j over the
      // tile's 64 queries, P and dS read down their columns
      const float* pc = p_s + 2 * cq * LDP + rg * 16 + gr;
      mma_pairs_x<8, NTW, NT, LD>(dv_acc, [&](int kk, float (&x)[4]) {
        x[0] = pc[kk * 8 * LDP];
        x[1] = pc[kk * 8 * LDP + 8];
        x[2] = pc[(kk * 8 + 1) * LDP];
        x[3] = pc[(kk * 8 + 1) * LDP + 8];
      }, g_s, u0, gr, cq);
      const float* dc = ds_s + 2 * cq * LDP + rg * 16 + gr;
      mma_pairs_x<8, NTW, NT, LD>(dk_acc, [&](int kk, float (&x)[4]) {
        x[0] = dc[kk * 8 * LDP];
        x[1] = dc[kk * 8 * LDP + 8];
        x[2] = dc[(kk * 8 + 1) * LDP];
        x[3] = dc[(kk * 8 + 1) * LDP + 8];
      }, q_s, u0, gr, cq);
      __syncthreads();  // every warp is done with this query tile's tiles
    }

    // dv straight from the registers; dk (and a single tile's dq) through
    // shared memory for the transposed RoPE, which mixes columns, with the
    // tables' rows loaded again where P and dS held them
    if (staged && (kTablesInP || !single)) {  // (a one-tile head's own region still holds them)
      load_table_rows<kTf32Tile, VEC, T>(tab_s, tab_s + kTf32Tile * D, cos_t, sin_t, k0, N, D);
      cp_async_commit();
    }
#pragma unroll
    for (int half_row = 0; half_row < 2; ++half_row) {
      const int r = r_lo + 8 * half_row;
      const int n = k0 + r;
#pragma unroll
      for (int uu = 0; uu < NTW; ++uu) {
        const int d = (u0 + uu) * 8 + 2 * cq;
        if (u0 + uu >= NT) continue;
        if (n < N && d < D)
          store_pair(dvb + n * dv.sn + d, dv_acc[uu][2 * half_row], dv_acc[uu][2 * half_row + 1]);
        store_pair(q_s + r * LD + d, dk_acc[uu][2 * half_row], dk_acc[uu][2 * half_row + 1]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    const long long trow = staged ? 0 : (long long)k0 * D;
    store_rows<T>(dkb, dk.sn, q_s, LD, k0, N, D, rope, ct + trow, stb + trow);
    if constexpr (single) store_rows<T>(dqb, dq.sn, v_s, LD, 0, N, D, rope, ct, stb);
    __syncthreads();  // before the next key tile's loads
  }
  if constexpr (!single) {
    // dq's sum, a query tile at a time through shared memory with the
    // tile's table rows, then its transposed RoPE
    __threadfence();
    for (int i = 0; i < tiles; ++i) {
      const int n0 = i * kTf32Tile;
      load_rows_f32<kTf32Tile, DP, 4, T>(q_s, dqa_h, DP, n0, N, DP);
      if (staged)
        load_table_rows<kTf32Tile, VEC, T>(tab_s, tab_s + kTf32Tile * D, cos_t, sin_t, n0, N, D);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      const long long trow = staged ? 0 : (long long)n0 * D;
      store_rows<T>(dqb, dq.sn, q_s, LD, n0, N, D, rope, ct + trow, stb + trow);
      __syncthreads();  // before the next tile's loads
    }
  }
}

}  // namespace

#endif  // VAVAE_ATTENTION_TF32_CUH
