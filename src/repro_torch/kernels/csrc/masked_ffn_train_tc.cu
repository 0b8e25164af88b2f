// The masked FFN's training forward, dx and dW for bf16 at large M, on
// Hopper's tensor cores (sm_90a): for C clients, each with its own weights and
// row masks,
//   forward  y  = ((act(x·Wg) ⊙ x·Wi) ⊙ row_mask) · Wo     (act(x·Wi) ungated)
//   dx       dx = dzh · Wiᵀ + dzg · Wgᵀ                      (dzh alone ungated)
//   dW       dWi = xᵀ·dzh, dWg = xᵀ·dzg, dWo = hmᵀ·gy
// x, gy (C, M, d), Wi/Wg (C, d, F), Wo (C, F, d) bf16; row_mask (C, M, F) fp32.
//
// Replaces, for bf16 inputs with at least 128 rows a client and d a
// multiple of 64 (kernels/masked_ffn.py tc_route), the Pallas kernels of
// repro/kernels/masked_ffn.py
//   train_fwd_kernel_tc_up / _down    <- _fwd_kernel (:107, via _fwd_impl :289)
//   train_dx_kernel_tc_up / _down     <- _dx_kernel  (:165, via _dx_impl :327)
//   train_dw_kernel_tc_up / _prod     <- _dw_kernel  (:193, via _dw_impl :367)
// with their semantics: a (row tile, 128-neuron f-block) tile is skipped
// when no row of the tile keeps any neuron of the block, and none of its
// weight bytes is read; kept tiles apply the exact per-row mask; the forward
// rounds the masked hidden activation to bf16 before the down product
// (:129); dx and dW recompute the pre-activations and keep hm, dzh and dzg
// in fp32 (_bwd_core :144); every sum is fp32, in a fixed order (no atomics:
// two calls give the same bits); a dW tile of an f-block no row keeps is
// written as exact zeros. Every other call (fp32, small M, d not a multiple
// of 64) runs masked_ffn_train.cu, which shares no code with this.
//
// What bounds them on an H100: operations. At StableLM-2-12B's FFN (C 1, M
// 1024, d 5120, F 13824, silu gated, 81 of 108 blocks kept) the forward is
// 326 GFLOP (0.330 ms at 989 TFLOP/s bf16) on ~0.4 GB (0.12 ms at 3.35 TB/s),
// dx 543 GFLOP as the roofline counts it (0.550 ms), dW 652 (0.660 ms); dx's
// down products and dW's weight products run three times over (below): 978
// GFLOP of products each. So the products run on wgmma (m64nNk16, bf16
// operands from shared memory, fp32 accumulators in registers), the card's
// only way to its full tensor-core rate (mma.sync reached ~300 TFLOP/s with
// these tiles on an H100), and nothing of the size of the output goes
// through device memory in fp32.
//
// Two launches a call, each a grid of blocks of two warpgroups:
//   up:   grid (128-row tiles, F / BF, C), warpgroup w taking the tile's
//         rows 64w .. 64w + 63. A block ORs the row mask over the tile's rows
//         and the whole 128-neuron f-block (the block of the f-block's first
//         half records it in `keep`); a dropped tile returns before any
//         weight load. A kept tile streams 64-deep stages of x
//         (and gy) and of the f-block's weight columns through an NS-stage
//         cp.async ring, in wgmma's 128-byte swizzled layouts (16-byte chunk
//         c of a 128-byte row r at chunk c ^ (r & 7), 1024-byte atoms; weight
//         rows along F in 64-column groups), and runs the f-block's products:
//           forward:   zh = x·Wi and zg = x·Wg, BF = 128 neurons a block;
//           dx and dW: zh, zg and ghm = gy·Woᵀ, BF = 64 neurons a block.
//         Each thread then applies mask and activation to its accumulators
//         as masked_ffn_train.cu does and writes
//           forward: h = bf16(act-and-gate(z) ⊙ mask) into h (C, M, F) bf16;
//           dx:      dzh (and dzg) in fp32, each split into three bf16 terms
//                    whose sum is exactly the fp32 value (split3, below), into
//                    planes (C, 3 or 6, M, F) bf16;
//           dW:      the same, then hm's three terms: (C, 6 or 9, M, F).
//   down (forward, dx): an output tile a block, the forward's 128 x 128
//         (warpgroup w taking its rows 64w ..), dx's 64 x 256 (warpgroup w
//         taking its columns 128w ..: dx stages three A tiles a step, and the
//         wider tile reads fewer bytes a product); grid (ceil(M / rows),
//         ceil(d / columns), C). Warp 0 lists the kept f-blocks of the
//         block's 128-row tile from `keep`, in f order, and only their rows
//         of h (or planes) and of the weights are staged: dropped blocks'
//         weights are never read.
//           forward: y  = Σ h[:, f]·Wo[f, :]
//           dx:      dx = Σ (dzh_hi + dzh_mid + dzh_lo)[:, f]·Wi[:, f]ᵀ (+ the
//                    same of dzg and Wg), the three terms of a 16-deep step
//                    against the one staged weight tile
//         one fp32 accumulator an output element over every kept f-block in
//         f order, rounded once to bf16. A row no kept block covers comes
//         out exactly 0.
//   prod (dW): a 256 (d) x 128 (f) tile of one product a block, warpgroup w
//         taking its rows 128w .. as two 64-row halves; grid (ceil(d / 256),
//         F / 128, C · products), products dWi [, dWg], dWo, the last
//         computed as dWoᵀ = gyᵀ·hm and stored transposed. Warp 0 lists the
//         f-block's kept row tiles from `keep`, in row order; 32-row stages
//         of x (or gy) and of the three planes of the f-block stream through
//         a PNS-stage ring, both operands MN-major (xᵀ and the planes read
//         from their row-major (M, ·) layout, in 64-column groups, as the
//         weights above), and each 16-deep step runs the hi, mid and lo terms
//         against the one staged xᵀ tile:
//           dWi[:, f] = Σ_m xᵀ[:, m]·(dzh_hi + dzh_mid + dzh_lo)[m, f]
//         one fp32 accumulator an output element over the kept row tiles in
//         row order, rounded once to bf16. An f-block with no kept row tile
//         reads nothing and writes zeros; a dropped row tile's planes, never
//         written, are never read. The tile is wide in d because the planes
//         are read three times a product: 20 KB staged a 16-deep step for 3.1
//         MFLOP (a 128 x 128 tile of dWi and dWg sharing xᵀ: 28 KB).
// Each stage i: wait for its copies and pass a barrier (by then every
// warpgroup has awaited stage i - 2's products), issue the copies of stage
// i + NS - 2 into stage i - 2's buffer, issue and commit the warpgroup's
// products of stage i, and await stage i - 1's.
// split3: hi = the top 16 bits of v (bf16 by truncation), mid = the same of
// v - hi, lo = v - hi - mid; each subtraction is exact and lo has at most 8
// significant bits, so hi + mid + lo == v for every finite v with |v| >=
// 2^-110 (below that, bits under bf16's least subnormal 2^-133 are lost);
// inf and NaN go whole into hi. Each term times a bf16 weight (or x, or gy)
// is exact in fp32, so dx's products are dzh·Wiᵀ's and dW's are xᵀ·dzh's
// and hmᵀ·gy's in fp32, as _dw_kernel's, and only the order of the sum
// differs from the FFMA kernels'.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::act_f;
using rt::dact_f;

constexpr int BN = 128;          // neurons per f-block (BLOCK_NEURONS)
constexpr int BM = 128;          // rows of a row tile (masked_ffn.TC_ROWS): two warpgroups of 64
constexpr int KC = 64;           // reduction depth of a ring stage: a 128-byte row of bf16
constexpr int THREADS = 256;     // two warpgroups
constexpr int TILE_B = BM * KC * 2;   // bytes of a 128 x 64 bf16 tile, either way round
constexpr int ATOM = 1024;       // bytes of a swizzle atom: 8 rows of 128 bytes
constexpr int NS = 4;            // cp.async ring stages: two in flight ahead of the products
constexpr int PLANES = 3;        // bf16 terms of an fp32 value in dx's and dW's products
constexpr int PW = 256;          // rows of d of a dW product tile: two warpgroups of 2 x 64
constexpr int PD = 32;           // rows of M of a dW product stage
constexpr int PNS = 5;           // dW product ring stages: three in flight ahead of the products
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory from its first 1024-byte boundary (the caller
// asks for ATOM bytes more).
__device__ __forceinline__ char* atom_aligned(char* p) {
  return p + ((ATOM - (smem_addr(p) & (ATOM - 1))) & (ATOM - 1));
}

// 16 bytes global -> shared; zeros where !full (nothing is read then).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This thread's shared-memory writes, seen by the async proxy (wgmma).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of r across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// wgmma's shared-memory descriptor of a 128-byte-swizzled operand at p:
// K-major (rows of 64 k, 8-row groups an atom apart), or N-major (rows of
// 64 columns along k, 8-row groups an atom apart, 64-column groups a stage
// tile's KC rows apart).
__device__ __forceinline__ uint64_t desc(const char* p, unsigned lbo) {
  return (uint64_t)((smem_addr(p) & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(ATOM >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_k(const char* p) { return desc(p, 16); }
__device__ __forceinline__ uint64_t desc_n(const char* p) { return desc(p, KC * 128); }

// d (+)= a·b over 16 of k for a warpgroup's 64 rows and N columns: a
// K-major (TA 0) or M-major (TA 1), b K-major (TB 0) or N-major (TB 1); d as
// mma.sync's fragments, an n8 column block j in d[4j .. 4j + 3].
template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TB), "n"(TA));
}

template <int TB, int TA = 0>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(TB), "n"(TA));
}

template <int N, int TB, int TA = 0>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 64) wgmma_n64<TB, TA>(d, a, b);
  else wgmma_n128<TB, TA>(d, a, b);
}

// A K-major tile: R rows of KC elements, row r from src + r·ld (rows >=
// rows_ok are zeros); chunk c of row r at chunk c ^ (r & 7) of its 128 bytes.
template <int R>
__device__ __forceinline__ void stage_k(char* dst, const bf16* src, size_t ld, int rows_ok,
                                        int tid) {
#pragma unroll
  for (int i = 0; i < R * 8 / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e >> 3, c = e & 7;
    const bool ok = r < rows_ok;
    cp16(dst + r * 128 + ((c ^ (r & 7)) << 4), ok ? src + (size_t)r * ld + c * 8 : src, ok);
  }
}

// An N-major (or M-major) tile: R rows (k) of W columns (n), row k from src
// + k·ld (16-byte chunks >= chunks_ok and rows >= rows_ok are zeros), as W /
// 64 groups of 64 columns, R rows of 128 bytes each; chunk c of a group's
// row k at c ^ (k & 7).
template <int W, int R = KC>
__device__ __forceinline__ void stage_n(char* dst, const bf16* src, size_t ld, int chunks_ok,
                                        int tid, int rows_ok = R) {
  constexpr int CH = W / 8;
#pragma unroll
  for (int i = 0; i < R * CH / THREADS; ++i) {
    const int e = tid + i * THREADS, r = e / CH, c = e % CH;
    const bool ok = c < chunks_ok && r < rows_ok;
    cp16(dst + (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4),
         ok ? src + (size_t)r * ld + c * 8 : src, ok);
  }
}

// v as hi + mid + lo, three bf16 (see the header).
__device__ __forceinline__ void split3(float v, bf16 (&p)[PLANES]) {
  if (!(fabsf(v) <= 3.402823466e38f)) {       // inf or NaN
    p[0] = __float2bfloat16(v);
    p[1] = p[2] = __float2bfloat16(0.f);
    return;
  }
  const unsigned u = __float_as_uint(v);
  const float r1 = v - __uint_as_float(u & 0xffff0000u);
  const unsigned u1 = __float_as_uint(r1);
  const float r2 = r1 - __uint_as_float(u1 & 0xffff0000u);
  p[0] = __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
  p[1] = __ushort_as_bfloat16(static_cast<unsigned short>(u1 >> 16));
  p[2] = __ushort_as_bfloat16(static_cast<unsigned short>(__float_as_uint(r2) >> 16));
}

// Two neighbouring fp32 values, split, into the three planes at dst (planes
// `plane` elements apart).
__device__ __forceinline__ void store_split(bf16* dst, size_t plane, float v0, float v1) {
  bf16 a[PLANES], b[PLANES];
  split3(v0, a);
  split3(v1, b);
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
    __nv_bfloat162 two;
    two.x = a[p];
    two.y = b[p];
    *reinterpret_cast<__nv_bfloat162*>(dst + p * plane) = two;
  }
}

// ---------------------------------------------------------------------------
// up

template <bool BWD, bool GATED>
struct Up {
  static constexpr int BF = BWD ? 64 : 128;       // neurons a block: a product's N
  static constexpr int NP = (GATED ? 2 : 1) + (BWD ? 1 : 0);   // zh [, zg] [, ghm]
  static constexpr int NA = BWD ? 2 : 1;          // A tiles: x [, gy]
  static constexpr int B_BYTES = KC * BF * 2;     // a weight tile
  static constexpr int STAGE = NA * TILE_B + NP * B_BYTES;
  static constexpr size_t SMEM = (size_t)NS * STAGE + ATOM;
};

// grid (row tiles, F / BF, C). out: h (C, M, F), or the planes (C, 3 or 6,
// M, F): dzh's hi, mid, lo, then dzg's; with HM (dW) hm's after them.
template <bool BWD, bool GATED, bool HM = false>
__device__ __forceinline__ void up_body(const bf16* __restrict__ gy, const bf16* __restrict__ x,
                                        const bf16* __restrict__ w_in,
                                        const bf16* __restrict__ w_gate,
                                        const bf16* __restrict__ w_out,
                                        const float* __restrict__ mask, int* __restrict__ keep,
                                        bf16* __restrict__ out, int M, int d, int F, int act) {
  using U = Up<BWD, GATED>;
  constexpr int BF = U::BF, NP = U::NP;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = atom_aligned(smem_raw);
  const int rt = blockIdx.x, c = blockIdx.z, nrt = gridDim.x, nfb = F / BN;
  const int f0 = blockIdx.y * BF, fb = f0 / BN, m0 = rt * BM, rows = min(BM, M - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, grp = warp >> 2;
  const size_t MF = (size_t)M * F, dF = (size_t)d * F;
  const float* mask_c = mask + c * MF;

  // tile skip: the OR of the mask over the tile's rows and the f-block
  bool any = false;
  const float* mrow = mask_c + (size_t)m0 * F + fb * BN;
#pragma unroll 4
  for (int e = tid; e < rows * (BN / 4); e += THREADS) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(mrow + (size_t)(e >> 5) * F) + (e & 31));
    any |= (v.x != 0.f) | (v.y != 0.f) | (v.z != 0.f) | (v.w != 0.f);
  }
  any = __syncthreads_or(any);
  if (tid == 0 && f0 % BN == 0) keep[((size_t)c * nrt + rt) * nfb + fb] = any ? 1 : 0;
  if (!any) return;

  const bf16* xa = x + (size_t)c * M * d + (size_t)m0 * d;
  const bf16* ga = BWD ? gy + (size_t)c * M * d + (size_t)m0 * d : nullptr;
  const bf16* wi = w_in + c * dF + f0;
  const bf16* wg = GATED ? w_gate + c * dF + f0 : nullptr;
  const bf16* wo = BWD ? w_out + c * dF + (size_t)f0 * d : nullptr;
  const int nk = d / KC;

  auto issue = [&](int i) {
    char* st = smem + (size_t)(i % NS) * U::STAGE;
    const int k0 = i * KC;
    stage_k<BM>(st, xa + k0, d, rows, tid);
    if constexpr (BWD) stage_k<BM>(st + TILE_B, ga + k0, d, rows, tid);
    char* bt = st + U::NA * TILE_B;
    stage_n<BF>(bt, wi + (size_t)k0 * F, F, BF / 8, tid);
    if constexpr (GATED) stage_n<BF>(bt + U::B_BYTES, wg + (size_t)k0 * F, F, BF / 8, tid);
    if constexpr (BWD) stage_k<BF>(bt + (NP - 1) * U::B_BYTES, wo + k0, d, BF, tid);
  };
#pragma unroll
  for (int i = 0; i < NS - 2; ++i) {
    if (i < nk) issue(i);
    commit_group();                        // empty groups too: the count stays fixed
  }
  float acc[NP][BF / 2];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int j = 0; j < BF / 2; ++j) acc[p][j] = 0.f;
    fence_regs(acc[p]);
  }
  for (int i = 0; i < nk; ++i) {
    wait_groups<NS - 3>();
    fence_async_smem();
    __syncthreads();                       // stage i landed; stage i - 2's products are done
    if (i + NS - 2 < nk) issue(i + NS - 2);
    commit_group();
    const char* st = smem + (size_t)(i % NS) * U::STAGE;
    const char* bt = st + U::NA * TILE_B;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      const uint64_t ax = desc_k(st + grp * (TILE_B / 2) + kk * 2);
      wgmma<BF, 1>(acc[0], ax, desc_n(bt + kk * 128));
      if constexpr (GATED) wgmma<BF, 1>(acc[1], ax, desc_n(bt + U::B_BYTES + kk * 128));
      if constexpr (BWD)
        wgmma<BF, 0>(acc[NP - 1], desc_k(st + TILE_B + grp * (TILE_B / 2) + kk * 2),
                     desc_k(bt + (NP - 1) * U::B_BYTES + kk * 2));
    }
    wg_commit();
    wg_wait<1>();                          // stage i - 1's products are done
  }
  wg_wait<0>();
#pragma unroll
  for (int p = 0; p < NP; ++p) fence_regs(acc[p]);

  // mask and activation, as masked_ffn_train.cu's warp_finish
  const int g = lane >> 2, t = lane & 3;
  constexpr int NMAT = GATED ? 2 : 1;      // dz planes: dzh [, dzg]
  bf16* out_c = out + (size_t)c * (BWD ? (NMAT + (HM ? 1 : 0)) * PLANES : 1) * MF;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = grp * 64 + (warp & 3) * 16 + g + 8 * hh;
    if (m >= rows) continue;
    const size_t row = (size_t)(m0 + m) * F;
#pragma unroll
    for (int j = 0; j < BF / 8; ++j) {
      const int f = f0 + 8 * j + 2 * t;
      const float2 rm2 = *reinterpret_cast<const float2*>(mask_c + row + f);
      const float rm[2] = {rm2.x, rm2.y};
      float o0[2], o1[2], hm[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 4 * j + 2 * hh + e;
        const float zh = acc[0][k];
        if constexpr (!BWD) {
          const float v = GATED ? act_f(acc[GATED ? 1 : 0][k], act) * zh : act_f(zh, act);
          o0[e] = rm[e] != 0.f ? v * rm[e] : 0.f;
        } else if constexpr (GATED) {
          const float zg = acc[1][k], ghm = acc[NP - 1][k] * rm[e], a = act_f(zg, act);
          o0[e] = ghm * a;
          o1[e] = ghm * zh * dact_f(zg, act);
          if constexpr (HM) hm[e] = a * zh * rm[e];
        } else {
          o0[e] = acc[NP - 1][k] * rm[e] * dact_f(zh, act);
          if constexpr (HM) hm[e] = act_f(zh, act) * rm[e];
        }
      }
      if constexpr (!BWD) {
        *reinterpret_cast<__nv_bfloat162*>(out_c + row + f) = __floats2bfloat162_rn(o0[0], o0[1]);
      } else {
        store_split(out_c + row + f, MF, o0[0], o0[1]);
        if constexpr (GATED) store_split(out_c + PLANES * MF + row + f, MF, o1[0], o1[1]);
        if constexpr (HM) store_split(out_c + NMAT * PLANES * MF + row + f, MF, hm[0], hm[1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// down

template <bool BWD, bool GATED>
struct Down {
  static constexpr int NMAT = BWD && GATED ? 2 : 1;   // weight matrices: Wo; or Wi [, Wg]
  static constexpr int NA = BWD ? PLANES : 1;         // A tiles a stage
  static constexpr int SUB = BN / KC;                 // stages of an f-block a matrix
  // a block's output tile: dx reads three A tiles a stage, so it takes
  // more columns (fewer bytes a product) over half the rows
  static constexpr int ROWS = BWD ? 64 : 128, COLS = BWD ? 256 : 128;
  // a warpgroup's rows and columns: the tile's 64-row halves, or its 64 rows
  // and a half of its columns
  static constexpr int WG_COLS = ROWS == 128 ? COLS : COLS / 2;
  static constexpr int A_BYTES = ROWS * KC * 2, W_BYTES = COLS * KC * 2;
  static constexpr int STAGE = NA * A_BYTES + W_BYTES;  // the A tiles, then the weight tile
  static size_t smem(int nfb) { return (size_t)NS * STAGE + ATOM + (size_t)nfb * sizeof(int); }
};

// grid (ceil(M / ROWS), ceil(d / COLS), C). forward: a = h (C, M, F), wa = Wo (C,
// F, d); dx: a = the planes (C, 3·NMAT, M, F), wa = Wi, wb = Wg (C, d, F).
// Stage i takes f-block list[i / (NMAT·SUB)], its (i / NMAT) % SUB-th
// 64-deep piece, of matrix i % NMAT.
template <bool BWD, bool GATED>
__device__ __forceinline__ void down_body(const bf16* __restrict__ a, const bf16* __restrict__ wa,
                                          const bf16* __restrict__ wb,
                                          const int* __restrict__ keep, bf16* __restrict__ out,
                                          int M, int d, int F) {
  using D = Down<BWD, GATED>;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = atom_aligned(smem_raw);
  __shared__ int s_nk;
  constexpr int ROWS = D::ROWS, COLS = D::COLS, N = D::WG_COLS;
  const int c = blockIdx.z, nrt = (M + BM - 1) / BM, nfb = F / BN;
  const int j0 = blockIdx.y * COLS, m0 = blockIdx.x * ROWS, rows = min(ROWS, M - m0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, grp = warp >> 2;
  const int wrow = ROWS == 128 ? 64 * grp : 0, wcol = ROWS == 128 ? 0 : N * grp;
  const size_t MF = (size_t)M * F, dF = (size_t)d * F;
  int* list = reinterpret_cast<int*>(smem + (size_t)NS * D::STAGE);   // kept f-blocks, in order

  if (warp == 0) {                       // the 128-row tile's kept f-blocks
    const int* kp = keep + ((size_t)c * nrt + m0 / BM) * nfb;
    int cnt = 0;
    for (int base = 0; base < nfb; base += 32) {
      const int fb = base + lane;
      const bool k = fb < nfb && kp[fb] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, k);
      if (k) list[cnt + __popc(bal & ((1u << lane) - 1u))] = fb;
      cnt += __popc(bal);
    }
    if (lane == 0) s_nk = cnt;
  }
  __syncthreads();
  const int n = s_nk * D::SUB * D::NMAT;
  const bf16* a_c = a + (size_t)c * D::NMAT * D::NA * MF + (size_t)m0 * F;
  const int cols_ok = min(COLS, d - j0);

  auto issue = [&](int i) {
    char* st = smem + (size_t)(i % NS) * D::STAGE;
    const int mat = i % D::NMAT;
    const int k0 = list[i / (D::NMAT * D::SUB)] * BN + (i / D::NMAT) % D::SUB * KC;
    if constexpr (!BWD) {
      stage_k<ROWS>(st, a_c + k0, F, rows, tid);
      stage_n<COLS>(st + D::A_BYTES, wa + c * dF + (size_t)k0 * d + j0, d, cols_ok / 8, tid);
    } else {
#pragma unroll
      for (int p = 0; p < PLANES; ++p)
        stage_k<ROWS>(st + p * D::A_BYTES, a_c + (size_t)(mat * PLANES + p) * MF + k0, F, rows,
                      tid);
      stage_k<COLS>(st + PLANES * D::A_BYTES, (mat ? wb : wa) + c * dF + (size_t)j0 * F + k0,
                    F, cols_ok, tid);
    }
  };
#pragma unroll
  for (int i = 0; i < NS - 2; ++i) {
    if (i < n) issue(i);
    commit_group();
  }
  float acc[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = 0.f;
  fence_regs(acc);
  for (int i = 0; i < n; ++i) {
    wait_groups<NS - 3>();
    fence_async_smem();
    __syncthreads();                       // stage i landed; stage i - 2's products are done
    if (i + NS - 2 < n) issue(i + NS - 2);
    commit_group();
    const char* st = smem + (size_t)(i % NS) * D::STAGE;
    const char* wt = st + D::NA * D::A_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      if constexpr (!BWD) {
        wgmma<N, 1>(acc, desc_k(st + wrow * 128 + kk * 2),
                    desc_n(wt + (wcol / 64) * (KC * 128) + kk * 128));
      } else {
        const uint64_t b = desc_k(wt + wcol * 128 + kk * 2);
#pragma unroll
        for (int p = 0; p < PLANES; ++p)    // hi, mid, lo against one weight tile
          wgmma<N, 0>(acc, desc_k(st + p * D::A_BYTES + wrow * 128 + kk * 2), b);
      }
    }
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  fence_regs(acc);

  const int g = lane >> 2, t = lane & 3;
  bf16* out_c = out + (size_t)c * M * d;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int m = wrow + (warp & 3) * 16 + g + 8 * hh;
    if (m >= rows) continue;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int col = j0 + wcol + 8 * j + 2 * t;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(out_c + (size_t)(m0 + m) * d + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// prod (dW)

template <bool GATED>
struct Prod {
  static constexpr int NPROD = GATED ? 3 : 2;          // dWi [, dWg], dWo
  static constexpr int SUB = BM / PD;                  // stages of a row tile
  static constexpr int A_BYTES = PD * PW * 2;          // xᵀ (or gyᵀ): 4 groups of 64 rows of d
  static constexpr int P_BYTES = PD * BN * 2;          // a plane: 2 groups of 64 neurons
  static constexpr int STAGE = A_BYTES + PLANES * P_BYTES;
  static size_t smem(int nrt) { return (size_t)PNS * STAGE + ATOM + (size_t)nrt * sizeof(int); }
};

// grid (ceil(d / PW), F / BN, C · NPROD); planes (C, 3·NPROD, M, F) as the
// dW up kernel writes them. Block (dt, fb, c·NPROD + p) computes rows d0 ..
// d0 + PW of d and the f-block's 128 neurons of product p: a·planes[3p ..
// 3p + 2], a = x (dWi, dWg) or gy (dWo, stored transposed). Stage i takes
// kept row tile list[i / SUB], its (i % SUB)-th 32 rows.
template <bool GATED>
__device__ __forceinline__ void prod_body(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                                          const bf16* __restrict__ planes,
                                          const int* __restrict__ keep, bf16* __restrict__ dw_in,
                                          bf16* __restrict__ dw_gate, bf16* __restrict__ dw_out,
                                          int M, int d, int F) {
  using P = Prod<GATED>;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = atom_aligned(smem_raw);
  __shared__ int s_n;
  const int nrt = (M + BM - 1) / BM, nfb = F / BN;
  const int d0 = blockIdx.x * PW, fb = blockIdx.y, f0 = fb * BN;
  const int c = blockIdx.z / P::NPROD, p = blockIdx.z % P::NPROD;
  const bool out_prod = p == P::NPROD - 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, grp = warp >> 2;
  const size_t MF = (size_t)M * F, dF = (size_t)d * F;
  int* list = reinterpret_cast<int*>(smem + (size_t)PNS * P::STAGE);   // kept row tiles, in order

  if (warp == 0) {                       // the f-block's kept row tiles
    int cnt = 0;
    for (int base = 0; base < nrt; base += 32) {
      const int rt = base + lane;
      const bool k = rt < nrt && keep[((size_t)c * nrt + rt) * nfb + fb] != 0;
      const unsigned bal = __ballot_sync(0xffffffffu, k);
      if (k) list[cnt + __popc(bal & ((1u << lane) - 1u))] = rt;
      cnt += __popc(bal);
    }
    // a ragged last row tile, kept, takes only the stages that hold rows
    const int tail = keep[((size_t)c * nrt + nrt - 1) * nfb + fb] != 0
                         ? P::SUB - (M - (nrt - 1) * BM + PD - 1) / PD : 0;
    if (lane == 0) s_n = cnt * P::SUB - tail;
  }
  __syncthreads();
  const int n = s_n;
  const bf16* a_c = (out_prod ? gy : x) + (size_t)c * M * d + d0;
  const bf16* p_c = planes + ((size_t)c * P::NPROD + p) * PLANES * MF + f0;
  const int chunks_ok = min(PW, d - d0) / 8;

  auto issue = [&](int i) {
    char* st = smem + (size_t)(i % PNS) * P::STAGE;
    const int m0 = list[i / P::SUB] * BM + (i % P::SUB) * PD, rows = M - m0;
    stage_n<PW, PD>(st, a_c + (size_t)m0 * d, d, chunks_ok, tid, rows);
#pragma unroll
    for (int t = 0; t < PLANES; ++t)
      stage_n<BN, PD>(st + P::A_BYTES + t * P::P_BYTES, p_c + t * MF + (size_t)m0 * F, F, BN / 8,
                      tid, rows);
  };
#pragma unroll
  for (int i = 0; i < PNS - 2; ++i) {
    if (i < n) issue(i);
    commit_group();
  }
  float acc[2][BN / 2];                  // the warpgroup's two 64-row halves of d
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[h][j] = 0.f;
    fence_regs(acc[h]);
  }
  for (int i = 0; i < n; ++i) {
    wait_groups<PNS - 3>();
    fence_async_smem();
    __syncthreads();                       // stage i landed; stage i - 2's products are done
    if (i + PNS - 2 < n) issue(i + PNS - 2);
    commit_group();
    const char* st = smem + (size_t)(i % PNS) * P::STAGE;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < PD; kk += 16) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t a = desc(st + (2 * grp + h) * (PD * 128) + kk * 128, PD * 128);
#pragma unroll
        for (int t = 0; t < PLANES; ++t)   // hi, mid, lo against one xᵀ tile
          wgmma<BN, 1, 1>(acc[h], a, desc(st + P::A_BYTES + t * P::P_BYTES + kk * 128, PD * 128));
      }
    }
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
#pragma unroll
  for (int h = 0; h < 2; ++h) fence_regs(acc[h]);

  const int g = lane >> 2, t = lane & 3;
  bf16* dst = (out_prod ? dw_out : p == 0 ? dw_in : dw_gate) + c * dF;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = d0 + 128 * grp + 64 * h + (warp & 3) * 16 + g + 8 * hh;   // row of d
      if (k >= d) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int f = f0 + 8 * j + 2 * t;
        const float v0 = acc[h][4 * j + 2 * hh], v1 = acc[h][4 * j + 2 * hh + 1];
        if (out_prod) {
          dst[(size_t)f * d + k] = __float2bfloat16_rn(v0);
          dst[(size_t)(f + 1) * d + k] = __float2bfloat16_rn(v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)k * F + f) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }
}

// The kernels, named as the forward's and dx's (the benchmark's readers
// match these names).
template <bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
train_fwd_kernel_tc_up(const bf16* __restrict__ x, const bf16* __restrict__ w_in,
                       const bf16* __restrict__ w_gate, const float* __restrict__ mask,
                       int* __restrict__ keep, bf16* __restrict__ h, int M, int d, int F,
                       int act) {
  up_body<false, GATED>(nullptr, x, w_in, w_gate, nullptr, mask, keep, h, M, d, F, act);
}

template <bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
train_dx_kernel_tc_up(const bf16* __restrict__ gy, const bf16* __restrict__ x,
                      const bf16* __restrict__ w_in, const bf16* __restrict__ w_gate,
                      const bf16* __restrict__ w_out, const float* __restrict__ mask,
                      int* __restrict__ keep, bf16* __restrict__ planes, int M, int d, int F,
                      int act) {
  up_body<true, GATED>(gy, x, w_in, w_gate, w_out, mask, keep, planes, M, d, F, act);
}

template <bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
train_dw_kernel_tc_up(const bf16* __restrict__ gy, const bf16* __restrict__ x,
                      const bf16* __restrict__ w_in, const bf16* __restrict__ w_gate,
                      const bf16* __restrict__ w_out, const float* __restrict__ mask,
                      int* __restrict__ keep, bf16* __restrict__ planes, int M, int d, int F,
                      int act) {
  up_body<true, GATED, true>(gy, x, w_in, w_gate, w_out, mask, keep, planes, M, d, F, act);
}

__global__ void __launch_bounds__(THREADS, 1)
train_fwd_kernel_tc_down(const bf16* __restrict__ h, const bf16* __restrict__ w_out,
                         const int* __restrict__ keep, bf16* __restrict__ y, int M, int d,
                         int F) {
  down_body<false, false>(h, w_out, nullptr, keep, y, M, d, F);
}

template <bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
train_dx_kernel_tc_down(const bf16* __restrict__ planes, const bf16* __restrict__ w_in,
                        const bf16* __restrict__ w_gate, const int* __restrict__ keep,
                        bf16* __restrict__ dx, int M, int d, int F) {
  down_body<true, GATED>(planes, w_in, w_gate, keep, dx, M, d, F);
}

template <bool GATED>
__global__ void __launch_bounds__(THREADS, 1)
train_dw_kernel_tc_prod(const bf16* __restrict__ x, const bf16* __restrict__ gy,
                        const bf16* __restrict__ planes, const int* __restrict__ keep,
                        bf16* __restrict__ dw_in, bf16* __restrict__ dw_gate,
                        bf16* __restrict__ dw_out, int M, int d, int F) {
  prod_body<GATED>(x, gy, planes, keep, dw_in, dw_gate, dw_out, M, d, F);
}

// Lets `kern` take as much dynamic shared memory as a block may have beside
// its static shared memory (a launch asks for what it needs).
cudaError_t allow_smem(const void* kern) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kern);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)(MAX_SMEM - a.sharedSizeBytes));
  return err;
}

template <bool BWD, bool GATED>
cudaError_t launch(const bf16* gy, const bf16* x, const bf16* w_in, const bf16* w_gate,
                   const bf16* w_out, const float* mask, int* keep, bf16* scratch, bf16* out,
                   int C, int M, int d, int F, int act, cudaStream_t s) {
  using U = Up<BWD, GATED>;
  using D = Down<BWD, BWD && GATED>;
  const int nrt = (M + BM - 1) / BM, nfb = F / BN;
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = allow_smem(
        BWD ? reinterpret_cast<const void*>(train_dx_kernel_tc_up<GATED>)
            : reinterpret_cast<const void*>(train_fwd_kernel_tc_up<GATED>));
    if (err == cudaSuccess)
      err = allow_smem(BWD ? reinterpret_cast<const void*>(train_dx_kernel_tc_down<GATED>)
                           : reinterpret_cast<const void*>(train_fwd_kernel_tc_down));
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  cudaError_t err;
  const dim3 up_grid(nrt, F / U::BF, C);
  const dim3 dn_grid((M + D::ROWS - 1) / D::ROWS, (d + D::COLS - 1) / D::COLS, C);
  if (BWD)
    train_dx_kernel_tc_up<GATED><<<up_grid, THREADS, U::SMEM, s>>>(
        gy, x, w_in, w_gate, w_out, mask, keep, scratch, M, d, F, act);
  else
    train_fwd_kernel_tc_up<GATED><<<up_grid, THREADS, U::SMEM, s>>>(
        x, w_in, w_gate, mask, keep, scratch, M, d, F, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (BWD)
    train_dx_kernel_tc_down<GATED><<<dn_grid, THREADS, D::smem(nfb), s>>>(
        scratch, w_in, w_gate, keep, out, M, d, F);
  else
    train_fwd_kernel_tc_down<<<dn_grid, THREADS, D::smem(nfb), s>>>(scratch, w_out, keep, out,
                                                                    M, d, F);
  return cudaGetLastError();
}

template <bool GATED>
cudaError_t launch_dw(const bf16* gy, const bf16* x, const bf16* w_in, const bf16* w_gate,
                      const bf16* w_out, const float* mask, int* keep, bf16* planes,
                      bf16* dw_in, bf16* dw_gate, bf16* dw_out, int C, int M, int d, int F,
                      int act, cudaStream_t s) {
  using U = Up<true, GATED>;
  using P = Prod<GATED>;
  const int nrt = (M + BM - 1) / BM;
  static bool allowed = false;
  if (!allowed) {
    cudaError_t err = allow_smem(reinterpret_cast<const void*>(train_dw_kernel_tc_up<GATED>));
    if (err == cudaSuccess)
      err = allow_smem(reinterpret_cast<const void*>(train_dw_kernel_tc_prod<GATED>));
    if (err != cudaSuccess) return err;
    allowed = true;
  }
  train_dw_kernel_tc_up<GATED><<<dim3(nrt, F / U::BF, C), THREADS, U::SMEM, s>>>(
      gy, x, w_in, w_gate, w_out, mask, keep, planes, M, d, F, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  train_dw_kernel_tc_prod<GATED><<<dim3((d + PW - 1) / PW, F / BN, C * P::NPROD), THREADS,
                                   P::smem(nrt), s>>>(x, gy, planes, keep, dw_in, dw_gate,
                                                      dw_out, M, d, F);
  return cudaGetLastError();
}

}  // namespace

// The forward (gy null) or dx of the training form on the tensor cores. All
// pointers are device pointers of row-major arrays, 16-byte aligned: x, gy
// (C, M, d), w_in, w_gate (C, d, F), w_out (C, F, d) and out (C, M, d)
// bf16, w_gate null when ungated; mask (C, M, F) fp32. Scratch from the
// caller: keep (C, ceil(M/128), F/128) int32, and bf16 scratch of (C, M, F)
// (forward: the hidden activation) or (C, 3 or 6, M, F) (dx: dzh's and
// dzg's planes). Requires d % 64 == 0 and F % 128 == 0. Returns the first
// nonzero error of the two launches; allocates nothing, never synchronises.
extern "C" int masked_ffn_train_tc_launch(const void* gy, const void* x, const void* w_in,
                                          const void* w_gate, const void* w_out,
                                          const float* mask, int* keep, void* scratch, void* out,
                                          int C, int M, int d, int F, int act, void* stream) {
  if (C <= 0 || M <= 0) return cudaSuccess;
  if (d <= 0 || d % KC || F <= 0 || F % BN) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bg = static_cast<const bf16*>(gy);
  const auto* bx = static_cast<const bf16*>(x);
  const auto* bi = static_cast<const bf16*>(w_in);
  const auto* bgt = static_cast<const bf16*>(w_gate);
  const auto* bo = static_cast<const bf16*>(w_out);
  auto* sc = static_cast<bf16*>(scratch);
  auto* o = static_cast<bf16*>(out);
  cudaError_t err;
  if (gy == nullptr)
    err = w_gate ? launch<false, true>(bg, bx, bi, bgt, bo, mask, keep, sc, o, C, M, d, F, act, s)
                 : launch<false, false>(bg, bx, bi, bgt, bo, mask, keep, sc, o, C, M, d, F, act, s);
  else
    err = w_gate ? launch<true, true>(bg, bx, bi, bgt, bo, mask, keep, sc, o, C, M, d, F, act, s)
                 : launch<true, false>(bg, bx, bi, bgt, bo, mask, keep, sc, o, C, M, d, F, act, s);
  return rt::cleared(err);
}

// dW of the training form on the tensor cores: dw_in, dw_gate (C, d, F) and
// dw_out (C, F, d) bf16, dw_gate null when ungated; the other pointers as
// masked_ffn_train_tc_launch's. Scratch from the caller: keep (C,
// ceil(M/128), F/128) int32 and planes (C, 3·(2 or 3), M, F) bf16 (dzh's,
// [dzg's,] hm's three terms). Requires d % 64 == 0 and F % 128 == 0. Returns
// the first nonzero error of the two launches; allocates nothing, never
// synchronises.
extern "C" int masked_ffn_dw_tc_launch(const void* gy, const void* x, const void* w_in,
                                       const void* w_gate, const void* w_out, const float* mask,
                                       int* keep, void* planes, void* dw_in, void* dw_gate,
                                       void* dw_out, int C, int M, int d, int F, int act,
                                       void* stream) {
  if (C <= 0 || M <= 0) return cudaSuccess;
  if (d <= 0 || d % KC || F <= 0 || F % BN) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* bg = static_cast<const bf16*>(gy);
  const auto* bx = static_cast<const bf16*>(x);
  const auto* bi = static_cast<const bf16*>(w_in);
  const auto* bgt = static_cast<const bf16*>(w_gate);
  const auto* bo = static_cast<const bf16*>(w_out);
  auto* pl = static_cast<bf16*>(planes);
  auto* di = static_cast<bf16*>(dw_in);
  auto* dg = static_cast<bf16*>(dw_gate);
  auto* dout = static_cast<bf16*>(dw_out);
  const cudaError_t err =
      w_gate ? launch_dw<true>(bg, bx, bi, bgt, bo, mask, keep, pl, di, dg, dout, C, M, d, F, act, s)
             : launch_dw<false>(bg, bx, bi, bgt, bo, mask, keep, pl, di, dg, dout, C, M, d, F, act,
                                s);
  return rt::cleared(err);
}
