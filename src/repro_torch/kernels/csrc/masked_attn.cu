// Head-masked attention projections for training on Hopper (sm_90a): the
// forward and backward of the Q/K/V projection y = x·W and the O merge
// y = a·W_o, where a client's dropped heads are skipped, for C clients at
// once, each with its own weights and (C, H) 0/1 head mask. Heads are
// contiguous in the head-partitioned axis, head-dim fastest (hd columns or
// rows per head).
//
// Replaces the Pallas kernels of repro/kernels/masked_attn.py as the fleet
// runs them under jax.vmap (one grid axis more per client). Three kernel
// bodies cover the six functions, one launch each:
//   head_slab_kernel  per-head output slab, zero if dropped
//     masked_head_proj_launch      <- _proj_kernel     (:54, via _proj_vjp._impl :153)
//     masked_head_merge_da_launch  <- _merge_da_kernel (:120, via _merge_vjp._da :242)
//   head_sum_kernel   sum over the kept heads into one output, head order
//     masked_head_proj_dx_launch   <- _proj_dx_kernel  (:68, via _proj_vjp._dx :171)
//     masked_head_merge_launch     <- _merge_kernel    (:103, via _merge_vjp._impl :224)
//   head_dw_kernel    per-head dW slab, m-tiles split across a cluster
//     masked_head_proj_dw_launch   <- _proj_dw_kernel  (:85, via _proj_vjp._dw :189)
//     masked_head_merge_dw_launch  <- _proj_dw_kernel  (:85, via _merge_vjp._dw :260)
//
// What bounds it on an H100: at the femnist_attn widths (M 490 rows a
// client, d 64, H 4 heads of hd 16, fp32) a client's call moves about
// 0.27 MB for 4 MFLOP, 15 FLOP per byte. A whole call at C 5 is a fraction
// of a microsecond of memory time and is bound by one block's chain of
// latencies (launch, mask read, a staging round trip, ~1000 FMAs a thread,
// stores); at C 64 by the FMAs and the bytes, each ~4-5 us of work.
//
// The slab and sum kernels stage, through a cp.async ring, only what a
// block uses, as the Pallas BlockSpecs cut it ((bm, din) x (din, hs) and
// (bm, hs) x (hs, d)): a row tile of the inputs and the kept heads' weight
// slabs, in chunks of the reduction, so their shared memory does not grow
// with the widths. A thread holds a 4 x 4 register tile (8 x 4 or 8 x 8 in
// the large tiles) fed by 16-byte shared loads, 0.125 loads a FMA or fewer,
// with the next step's loads in flight. Each body has two tiles, picked at
// launch from the grid: a small one that gives a C 5 call 160 blocks (one
// head of a 64-row tile, or a 32 x 32 tile of the summed output), and a
// large one for grids of 264 blocks or more, where a slab block takes
// several heads and stages their shared inputs once. fp32 FFMA throughout,
// so the sums are the plain version's up to order within a dot product.
// The dW kernel splits each slab's m-tiles over several blocks, 80 blocks
// at C 5 where one block a slab gave 20; at C 64 its 1024 blocks are bound
// by a fixed latency chain each (mask, first stage, warp sums, push,
// barrier) and by staging the operand that all heads share once per head.
//
// Hopper has no sequential grid, so the Pallas accumulators revisited
// across the grid become loops inside one block or a fixed-order sum
// across the blocks of a cluster. The sum kernel walks its client's kept
// heads in order and adds each head's fp32 partial (a register tile) to
// its running total when the head is done (acc = 0 + p_h0, + p_h1, ...),
// as the Pallas accumulator and the plain version do. The dW kernel splits
// a (client, head) slab's 128-row m-tiles across a thread-block cluster of
// min(m-tiles, 8) blocks: block b computes the fp32 partials of tiles b,
// b + cs, ..., staging rows with cp.async, one row group a warp and an
// 8x4 register tile a lane; each block pushes its partial into the shared
// memory of the blocks that sum each share of the slab, and after one
// cluster barrier those add the partials in m-tile order (acc = p0, + p1,
// + p2, ...), as the Pallas accumulator and the plain version do. No
// atomics and no workspace: two calls give the same bits, whatever the
// cluster size. A dropped head's outputs are written as explicit zeros
// (outputs come from torch.empty), and its products are skipped. The mask
// is data read on the device: a new keep-map never builds a new kernel.
#include <cooperative_groups.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;    // dW blocks; the most threads of a slab or sum block
constexpr int MT = 128;         // rows of an m-tile of the dW sums (Pallas block_m)
constexpr int RS = 64;          // dW: rows of one cp.async stage
constexpr int NST = 3;          // dW: stages in the ring
constexpr int SUB = MT / RS;    // dW: stages of an m-tile
constexpr int MI = 8, MJ = 4;   // dW: a thread's register tile, MI x MJ outputs
constexpr int UT = 32;          // dW: register tiles of a chunk, one per lane
constexpr int MAX_CI = 16;      // dW: most register tiles of a chunk along i
constexpr int GR = THREADS / UT;      // dW: row groups, one per warp (8)
constexpr int NF = UT * MI * MJ;      // dW: outputs of a chunk (1024)
constexpr int SHARE = NF / THREADS;   // dW: most outputs a thread sums (4)
constexpr int MAX_CLUSTER = 8;        // portable cluster size
constexpr size_t STATIC_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 227 * 1024;

// slab and sum: a block's tile of TM rows, a thread's register tile of
// RM x RN, the longest reduction chunk a stage holds (RC), the most
// columns of a head chunk (slab) or of a tile (sum) (BN), the stages of the
// cp.async ring (NS). Each body has a small tile, for launches with few
// row tiles (femnist_attn's 5 clients), and a large one that takes fewer,
// fuller blocks where the grid is large (64 clients); TM / RM * BN / RN
// <= THREADS.
struct Tile { int TM, RM, RN, RC, BN, NS; };
constexpr int SLAB_RC = 64, SLAB_NS = 2, SUM_RC = 64, SUM_NS = 3;
constexpr Tile SLAB_SMALL{64, 4, 4, SLAB_RC, 64, SLAB_NS};
constexpr Tile SLAB_LARGE{64, 8, 4, SLAB_RC, 64, SLAB_NS};
constexpr Tile SUM_SMALL{32, 4, 4, SUM_RC, 32, SUM_NS};
constexpr Tile SUM_LARGE{64, 8, 8, SUM_RC, 64, SUM_NS};
// A slab launch takes the large tile and gives a block G > 1 heads where
// that still leaves MIN_BLOCKS blocks (G the most that does); a sum launch
// takes the large tile where that gives MIN_BLOCKS blocks.
constexpr int MIN_BLOCKS = 264;

enum Body : int { kSlab = 0, kSum = 1 };

int imin(int a, int b) { return a < b ? a : b; }
int imax(int a, int b) { return a > b ? a : b; }

// How the dW kernel cuts a (client, head) slab of I x J outputs. A chunk
// is CI x CJ register tiles of MI x MJ, one per lane: CJ the least power
// of two that covers the slab's tiles along j (at most UT), CI = UT / CJ
// (at most MAX_CI, which bounds a stage row); the slab has nci x ncj
// chunks. The M rows are T m-tiles, split over a cluster of cs blocks.
// Shared memory: a ring of NST stages of RS rows of the chunk's L columns
// (row stride sl elements of the input type) and R columns (sr), GR planes
// of NF fp32 partials, and cs slots of `share` fp32 partials that the
// cluster's blocks push: at most 140 KB.
struct DwGeom {
  int T, cs;          // m-tiles; blocks of a cluster
  int cj_log, ci;     // log2 CJ; CI
  int nci, ncj;       // chunks along i and j
  int sl, sr;         // stage row strides, elements
  int share;          // outputs of a chunk each block of the cluster sums
  int vl, vr;         // bytes per cp.async of L rows and of R rows
  int smem;           // dynamic shared memory, bytes
};

DwGeom dw_geom(int M, int I, int J, int elem) {
  DwGeom g{};
  const int nI = (I + MI - 1) / MI, nJ = (J + MJ - 1) / MJ;
  while ((1 << g.cj_log) < nJ && (1 << g.cj_log) < UT) ++g.cj_log;
  const int CJ = 1 << g.cj_log, CI = UT / CJ < MAX_CI ? UT / CJ : MAX_CI, ve = 16 / elem;
  g.ci = CI;
  g.nci = (nI + CI - 1) / CI;
  g.ncj = (nJ + CJ - 1) / CJ;
  g.T = (M + MT - 1) / MT;
  g.cs = g.T < 1 ? 1 : (g.T < MAX_CLUSTER ? g.T : MAX_CLUSTER);
  g.share = ((NF + g.cs - 1) / g.cs + 3) / 4 * 4;   // float4-aligned shares
  g.sl = (CI * MI + ve - 1) / ve * ve;              // rows start 16-byte aligned
  g.sr = (CJ * MJ + ve - 1) / ve * ve;
  g.smem = NST * RS * (g.sl + g.sr) * elem +
           (int)sizeof(float) * (GR * NF + g.cs * g.share);
  return g;
}

// The widest copy, 16, 8, 4 or 2 bytes, that divides every byte offset a
// row copy starts at: row strides, head and chunk offsets, widths.
int copy_bytes(int elem, int a, int b, int c, int d) {
  const int offsets[4] = {a, b, c, d};
  int v = 16;
  for (int o : offsets)
    while ((o * elem) % v) v >>= 1;
  return v;
}

// How a slab or sum launch cuts its work. A block computes TM rows of
// outputs with G groups of tph threads, each thread an RM x RN register
// tile, reducing over chunks of at most RC staged in a ring of NS stages:
//   slab: group p owns whole head h0 + p, or, where hd > BN, G = 1 and the
//         block owns a column chunk of one head (nch chunks a head); the
//         reduction runs over K in nrc chunks. A stage holds the row
//         tile's inputs once for the block's heads and each kept head's
//         weight chunk.
//   sum:  G = 1; the block owns a chunk of the K outputs (nch chunks) and
//         walks the kept heads, P = RC / hd of them a job where hd <= RC,
//         else one head in nrc chunks. A stage holds those heads' columns
//         of the row tile side by side and their weight rows.
// Inputs are staged [TM][lda] (reduction fastest), a weight chunk (bstage
// elements) [rc][ldb] (columns fastest) or, transposed (bt), [bn][ldb]
// (reduction fastest). A row stride is an odd number of 16-byte units, so
// the consecutive rows that a quarter-warp reads lie in different banks.
// Shared memory does not grow with K or N: a stage holds at most G x (TM
// + BN) rows of RC and a pad.
struct MmGeom {
  int bn, ncg, nch;   // columns of a head chunk or tile; its groups of RN; chunks
  int G, tph;         // thread groups (heads) a block; threads a group
  int nrc;            // reduction chunks (slab: of K; sum: of one head's hd)
  int P, seg;         // sum: kept heads a job stages side by side, columns apart
  int lda, ldb;       // stage row strides, elements
  int bstage, stage;  // elements of one weight chunk and of one stage
  int va, vb;         // bytes per cp.async of A rows and of B rows
  int threads, smem;  // threads a block; dynamic shared memory, bytes
};

// Stage row stride, in elements, for rows of w elements: an odd number of
// 16-byte units.
int pad_ld(int w, int elem) {
  const int ve = 16 / elem;
  const int ld = (w + ve - 1) / ve * ve;
  return (ld / ve) % 2 ? ld : ld + ve;
}

// C clients of M rows; width: the non-head width (K: din or d); stages of
// `elem`-byte elements; G > 1 heads a block (slab) only if `groups`: the
// most that leave MIN_BLOCKS blocks. Returns the launch's blocks.
long long mm_geom(MmGeom& g, const Tile& tl, bool slab, bool bt, bool groups, int C, int M,
                  int width, int H, int hd, int elem) {
  g = MmGeom{};
  const int cols = slab ? hd : width, red = slab ? width : hd;
  g.bn = imin((cols + tl.RN - 1) / tl.RN * tl.RN, tl.BN);
  g.ncg = g.bn / tl.RN;
  g.nch = (cols + g.bn - 1) / g.bn;
  g.nrc = (red + tl.RC - 1) / tl.RC;
  g.tph = tl.TM / tl.RM * g.ncg;
  const long long tiles = (long long)((M + tl.TM - 1) / tl.TM) * C;
  g.G = 1;
  if (groups && g.nch == 1)
    for (int q = imin(H, THREADS / g.tph); q > 1; --q)
      if (tiles * ((H + q - 1) / q) >= MIN_BLOCKS) {
        g.G = q;
        break;
      }
  // a stage's reduction width: a chunk of K (slab); P segments of seg
  // columns, each a head (hd rounded up to 4, so vector loads stay
  // aligned) or a chunk of one (sum)
  g.seg = imin((red + 3) / 4 * 4, tl.RC);
  g.P = slab || hd > tl.RC ? 1 : imax(1, imin(H, tl.RC / g.seg));
  const int rc = slab ? imin(red, tl.RC) : (g.P > 1 ? g.P * g.seg : imin(red, tl.RC));
  g.lda = pad_ld(rc, elem);
  g.ldb = pad_ld(bt ? rc : g.bn, elem);
  g.bstage = (bt ? g.bn : rc) * g.ldb;
  g.stage = tl.TM * g.lda + g.G * g.bstage;
  // job j < jobs takes ring slot j % NS: a block with fewer jobs than NS
  // uses only the first `jobs` slots
  const int jobs = slab ? g.nrc : (H + g.P - 1) / g.P * g.nrc;
  g.threads = g.G * g.tph;
  g.smem = imin(tl.NS, jobs) * g.stage * elem;
  return tiles * (slab ? (H + g.G - 1) / g.G * g.nch : g.nch);
}

// The tile a launch takes (large: 1, small: 0) and its geometry; returns
// its blocks.
long long mm_pick(MmGeom& g, int& large, bool slab, bool bt, int C, int M, int width, int H,
                  int hd, int elem) {
  long long blocks =
      mm_geom(g, slab ? SLAB_LARGE : SUM_LARGE, slab, bt, slab, C, M, width, H, hd, elem);
  large = slab ? g.G > 1 : blocks >= MIN_BLOCKS;
  if (!large)
    blocks = mm_geom(g, slab ? SLAB_SMALL : SUM_SMALL, slab, bt, false, C, M, width, H, hd,
                     elem);
  return blocks;
}

template <typename Kern>
cudaError_t allow_smem(Kern* kern, size_t bytes) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= STATIC_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// One (client, head) dW slab: out[i][j] = Σ over 128-row m-tiles, in
// order, of Σ_{m in tile} L[m][i]·R[m][j]; i < I, j < J. L and R are row
// tiles of two (C, M, ·) operands, one of them cut to the head's columns:
//   proj dW:  L = x (width K = I),       R = gy[:, head] (J = hd),
//             out = dW[c][:, head]  (dW (C, K, N), row stride N)
//   merge dW: L = a[:, head] (I = hd),   R = gy (width d = J),
//             out = dW_o[c][head, :] (dW_o (C, N, d), row stride d)
struct DwArgs {
  const void* L;
  const void* R;
  void* out;
  int ldl, hl;        // L's row stride; column offset per head (0 or hd)
  int ldr, hr;        // R's row stride; column offset per head
  int I, J;           // the slab's shape
  int ldo;            // out's row stride
  long long ho;       // out's offset per head
  long long oc;       // out's elements per client
};

// One cp.async of B bytes from global to shared memory; B = 2 (bf16 at an
// odd element offset, which cp.async cannot copy) is a plain load and store.
template <int B>
__device__ __forceinline__ void copy_async(char* dst, const char* src) {
  if constexpr (B == 2) {
    *reinterpret_cast<unsigned short*>(dst) =
        __ldg(reinterpret_cast<const unsigned short*>(src));
  } else {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (B == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(B)
                   : "memory");
  }
}

// Copies rows of vpr vectors of vb bytes (global row stride ld bytes,
// shared sld) with the nt threads of a block. Thread tid starts at vector
// (r0, c0) of the flat order and steps by nt vectors as (dr, dc), so no
// index is divided in the loop.
struct RowCopy {
  int vb, vpr, r0, c0, dr, dc, sld;
  long long ld;
  __device__ RowCopy(int width_bytes, int vb_, long long ld_, int sld_, int nt = THREADS)
      : vb(vb_), vpr(width_bytes / vb_), sld(sld_), ld(ld_) {
    r0 = threadIdx.x / vpr;
    c0 = threadIdx.x % vpr;
    dr = nt / vpr;
    dc = nt % vpr;
  }
  template <int B>
  __device__ __forceinline__ void rows(char* dst, const char* src, int n) const {
    for (int r = r0, c = c0; r < n;) {
      copy_async<B>(dst + r * sld + c * B, src + r * ld + c * B);
      c += dc;
      r += dr;
      if (c >= vpr) { c -= vpr; ++r; }
    }
  }
  __device__ __forceinline__ void operator()(char* dst, const char* src, int n) const {
    switch (vb) {
      case 16: rows<16>(dst, src, n); break;
      case 8: rows<8>(dst, src, n); break;
      case 4: rows<4>(dst, src, n); break;
      default: rows<2>(dst, src, n);
    }
  }
};

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[8]) {
  float lo[4], hi[4];
  load4(p, lo);
  load4(p + 4, hi);
#pragma unroll
  for (int k = 0; k < 4; ++k) { v[k] = lo[k]; v[k + 4] = hi[k]; }
}

template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c, float d);

template <>
__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <>
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned*>(&lo);
  t.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

// One step of four along the reduction: A[i][r..r+3] into a, B[r..r+3][j]
// into b. as, bs, astep, ldb, bstep as mm_chunk has them.
template <typename T, bool BT, int RM, int RN>
__device__ __forceinline__ void mm_load(const T* __restrict__ as, int astep,
                                        const T* __restrict__ bs, int ldb, int bstep, int r,
                                        float (&a)[RM][4], float (&b)[4][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) load4(as + i * astep + r, a[i]);
#pragma unroll
  for (int v = 0; v < RN / 4; ++v)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float t[4];
      load4(BT ? bs + (v * 4 + q) * bstep + r : bs + (r + q) * ldb + v * bstep, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (BT) b[e][v * 4 + q] = t[e];
        else b[q][v * 4 + e] = t[e];
      }
    }
}

template <int RM, int RN>
__device__ __forceinline__ void mm_fma(const float (&a)[RM][4], const float (&b)[4][RN],
                                       float (&acc)[RM][RN]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a[i][q], b[q][j], acc[i][j]);
}

// acc[i][j] += Σ_{r < rc} A[i][r]·B[r][j] over one staged reduction chunk,
// r ascending, one fmaf chain an output. as: the thread's first A row, its
// rows astep apart. bs, BT = false (B staged [r][n]): the thread's first
// column in chunk row 0 (rows ldb apart), its columns in groups of four
// contiguous ones, bstep apart; BT = true (B staged [n][r]): the row of the
// thread's first column, each next column's row bstep further. Steps of
// four along r: RM + RN loads of four elements (16 bytes fp32, 8 bf16)
// feed RM x RN x 4 FMAs. A 4 x 4 tile keeps the next step's loads in
// flight while one step's FMAs run (two register buffers); a larger one
// has no registers to spare for that.
template <typename T, bool BT, int RM, int RN>
__device__ __forceinline__ void mm_chunk(const T* __restrict__ as, int astep,
                                         const T* __restrict__ bs, int ldb, int bstep,
                                         int rc, float (&acc)[RM][RN]) {
  const int steps = rc / 4;
  if (RM * RN > 16) {                                // large tiles: no registers to spare
    float a[RM][4], b[4][RN];
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      mm_load<T, BT>(as, astep, bs, ldb, bstep, 4 * s, a, b);
      mm_fma(a, b, acc);
    }
  } else if (steps > 0) {
    float a0[RM][4], b0[4][RN], a1[RM][4], b1[4][RN];
    mm_load<T, BT>(as, astep, bs, ldb, bstep, 0, a0, b0);
    int s = 0;
    for (; s + 2 <= steps; s += 2) {
      mm_load<T, BT>(as, astep, bs, ldb, bstep, 4 * s + 4, a1, b1);
      mm_fma(a0, b0, acc);
      if (s + 2 < steps) mm_load<T, BT>(as, astep, bs, ldb, bstep, 4 * s + 8, a0, b0);
      mm_fma(a1, b1, acc);
    }
    if (s < steps) mm_fma(a0, b0, acc);              // an odd step count
  }
  for (int r = steps * 4; r < rc; ++r) {             // a chunk that is not a multiple of 4
    float b[RN];
#pragma unroll
    for (int j = 0; j < RN; ++j)
      b[j] = rt::to_f(BT ? bs[j * bstep + r] : bs[r * ldb + j / 4 * bstep + j % 4]);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float a = rt::to_f(as[i * astep + r]);
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
    }
  }
}

// Writes a thread's register tile into the block's tile o (row stride
// ldo): rows r0 + i·rstep below `rows`, columns (BT: cg + j·ncg; else
// groups of four, cg·4 + e + v·ncg·4) below bn. vec: o and ldo are
// multiples of four elements, so four contiguous columns go as one store
// (16 bytes fp32, 8 bf16).
template <typename T, bool BT, int RM, int RN>
__device__ __forceinline__ void store_tile(T* o, int ldo, int rows, int bn, int r0,
                                           int rstep, int cg, int ncg, bool vec,
                                           const float (&v)[RM][RN]) {
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + i * rstep;
    if (r >= rows) break;
    T* orow = o + (size_t)r * ldo;
#pragma unroll
    for (int u = 0; u < RN / 4; ++u) {
      const int c0 = u * ncg * 4 + cg * 4;
      if (!BT && vec && c0 + 4 <= bn) {
        store4(orow + c0, v[i][u * 4], v[i][u * 4 + 1], v[i][u * 4 + 2], v[i][u * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = u * 4 + e, col = BT ? cg + j * ncg : c0 + e;
          if (col < bn) orow[col] = rt::from_f<T>(v[i][j]);
        }
      }
    }
  }
}

// out[c][m][j] = Σ_k in[c][m][k]·B(k, j) for the columns j of kept heads,
// exact zeros for those of dropped heads; j < N = H·hd.
//   TRANS = false: B(k, j) = w[c][k][j], w (C, K, N)    (proj)
//   TRANS = true:  B(k, j) = w[c][j][k], w (C, N, K)    (merge da)
// grid (row tiles of TM, head groups (or H x g.nch chunks), C): a
// block owns a row tile of g.G heads (or of one column chunk of one head),
// g.tph threads a head. It reads the heads' mask first: a block whose
// heads are all dropped writes its zeros and returns before it stages
// anything. Otherwise it stages K in chunks of SLAB_RC through a ring of
// SLAB_NS stages: the row tile's inputs, once for its heads, and each kept
// head's weight chunk. A head's threads each compute an RM x RN
// register tile of its slab; a dropped head's threads compute nothing and
// write zeros.
template <typename T, bool TRANS, int TM, int RM, int RN>
__global__ void __launch_bounds__(THREADS)
head_slab_kernel(const T* __restrict__ in, const T* __restrict__ w,
                 const float* __restrict__ mask, T* __restrict__ out, int M,
                 int K, int H, int hd, MmGeom g) {
  extern __shared__ __align__(16) unsigned char mm_sm[];
  constexpr int RG = TM / RM;                        // row groups of a head's threads
  T* stage = reinterpret_cast<T*>(mm_sm);
  const int tid = threadIdx.x, nt = blockDim.x, c = blockIdx.z, E = sizeof(T);
  const int h0 = g.nch > 1 ? blockIdx.y / g.nch : blockIdx.y * g.G;
  const int n0 = g.nch > 1 ? (blockIdx.y - h0 * g.nch) * g.bn : 0;
  const int nh = min(g.G, H - h0), bn = min(g.bn, hd - n0);
  const int q = tid / g.tph, t = tid - q * g.tph;    // this thread's head: h0 + q
  const int cg = t % g.ncg, rg = t / g.ncg;
  const int m0 = blockIdx.x * TM, rows = min(TM, M - m0), N = H * hd;
  const T* A = in + ((size_t)c * M + m0) * K;
  const T* B = TRANS ? w + ((size_t)c * N + h0 * hd + n0) * K
                     : w + (size_t)c * K * N + h0 * hd + n0;
  // the copies of a chunk of rc0 (every chunk but a ragged last one),
  // built while the mask is read: a copy's constructor divides
  const int rc0 = min(SLAB_RC, K);
  const RowCopy ca(rc0 * E, g.va, (long long)K * E, g.lda * E, nt);
  const RowCopy cb = TRANS ? RowCopy(rc0 * E, g.vb, (long long)K * E, g.ldb * E, nt)
                           : RowCopy(bn * E, g.vb, (long long)N * E, g.ldb * E, nt);
  const float* mk = mask + (size_t)c * H + h0;
  unsigned kept = 0;                                 // bit p: head h0 + p is kept
#pragma unroll 4
  for (int p = 0; p < nh; ++p) kept |= (mk[p] != 0.f ? 1u : 0u) << p;
  const bool mine = q < nh && (kept >> q & 1u);
  float acc[RM][RN] = {};
  if (kept) {                                        // block-uniform
    auto fetch = [&](int j) {
      if (j < g.nrc) {
        const int k0 = j * SLAB_RC, rc = min(SLAB_RC, K - k0);
        T* as = stage + (j % SLAB_NS) * g.stage;
        (rc == rc0 ? ca : RowCopy(rc * E, g.va, (long long)K * E, g.lda * E, nt))(
            reinterpret_cast<char*>(as), reinterpret_cast<const char*>(A + k0), rows);
        for (int p = 0; p < nh; ++p) {
          if (!(kept >> p & 1u)) continue;
          char* bs = reinterpret_cast<char*>(as + TM * g.lda + p * g.bstage);
          if (TRANS)                                 // bn weight rows of rc
            (rc == rc0 ? cb : RowCopy(rc * E, g.vb, (long long)K * E, g.ldb * E, nt))(
                bs, reinterpret_cast<const char*>(B + (size_t)p * hd * K + k0), bn);
          else                                       // rc weight rows of bn
            cb(bs, reinterpret_cast<const char*>(B + p * hd + (size_t)k0 * N), rc);
        }
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");   // empty groups too
    };
    for (int j = 0; j < SLAB_NS - 1; ++j) fetch(j);
    for (int j = 0; j < g.nrc; ++j) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(SLAB_NS - 2) : "memory");
      __syncthreads();                               // chunk j landed, j - 1 consumed
      fetch(j + SLAB_NS - 1);
      if (mine) {
        const T* as = stage + (j % SLAB_NS) * g.stage;
        const T* bs = as + TM * g.lda + q * g.bstage;
        mm_chunk<T, TRANS, RM, RN>(
            as + rg * g.lda, RG * g.lda, bs + (TRANS ? cg * g.ldb : cg * 4), g.ldb,
            TRANS ? g.ncg * g.ldb : g.ncg * 4, min(SLAB_RC, K - j * SLAB_RC), acc);
      }
    }
  }
  if (q < nh) {
    const int col0 = (h0 + q) * hd + n0;
    store_tile<T, TRANS, RM, RN>(out + ((size_t)c * M + m0) * N + col0, N, rows, bn, rg, RG,
                                 cg, g.ncg, N % 4 == 0 && col0 % 4 == 0, acc);
  }
}

// out[c][m][k] = Σ over kept heads h, in order, of the fp32 dot product
//                Σ_e in[c][m][h·hd + e]·B(h·hd + e, k);   k < K.
//   TRANS = false: B(j, k) = w[c][j][k], w (C, N, K)    (merge)
//   TRANS = true:  B(j, k) = w[c][k][j], w (C, K, N)    (proj dx)
// grid (row tiles of TM, column tiles of g.bn, C). A block counts its
// client's kept heads and walks them in order. One job stages g.P kept
// heads side by side (the row tile's columns of each, and each one's
// weight rows for the block's columns), or, where hd > SUM_RC, a chunk of
// one head, through a ring of SUM_NS stages, so the next job's slabs are in
// flight while one is computed. A head's partial is an RM x RN register
// tile a thread; when the head is done it is added to the running fp32
// total (acc = 0 + p_h0, + p_h1, ...). A client with no kept head gets
// exact zeros.
template <typename T, bool TRANS, int TM, int RM, int RN>
__global__ void __launch_bounds__(THREADS)
head_sum_kernel(const T* __restrict__ in, const T* __restrict__ w,
                const float* __restrict__ mask, T* __restrict__ out, int M,
                int K, int H, int hd, MmGeom g) {
  extern __shared__ __align__(16) unsigned char mm_sm[];
  constexpr int RG = TM / RM;                        // row groups
  T* stage = reinterpret_cast<T*>(mm_sm);
  const int tid = threadIdx.x, nt = blockDim.x, c = blockIdx.z, E = sizeof(T);
  const int n0 = blockIdx.y * g.bn, bn = min(g.bn, K - n0);
  const int m0 = blockIdx.x * TM, rows = min(TM, M - m0), N = H * hd;
  const int cg = tid % g.ncg, rg = tid / g.ncg;
  const T* A = in + ((size_t)c * M + m0) * N;
  const T* B = TRANS ? w + ((size_t)c * K + n0) * N : w + (size_t)c * N * K + n0;
  const float* mk = mask + (size_t)c * H;
  int kept = 0;
#pragma unroll 4
  for (int h = 0; h < H; ++h) kept += mk[h] != 0.f;
  // the copies of a job's usual piece, built while the mask is read (a
  // copy's constructor divides): g.P kept heads in a row, or a chunk of rc0
  // of one head
  const int rc0 = min(SUM_RC, hd), w0 = g.P > 1 ? g.P * hd : rc0;
  const RowCopy ca(w0 * E, g.va, (long long)N * E, g.lda * E, nt);
  const RowCopy cb = TRANS ? RowCopy(w0 * E, g.vb, (long long)N * E, g.ldb * E, nt)
                           : RowCopy(bn * E, g.vb, (long long)K * E, g.ldb * E, nt);
  const int jobs = (kept + g.P - 1) / g.P * g.nrc;
  int fh = -1, fe = g.nrc - 1, left = kept;          // last head and chunk fetched
  // stages columns col, col + 1, ... (wd of them) of the row tile and the
  // weight's matching rows at segment offset s0 of a stage
  auto piece = [&](T* as, T* bs, int s0, int col, int wd) {
    (wd == w0 ? ca : RowCopy(wd * E, g.va, (long long)N * E, g.lda * E, nt))(
        reinterpret_cast<char*>(as + s0), reinterpret_cast<const char*>(A + col), rows);
    if (TRANS)                                       // bn weight rows of wd
      (wd == w0 ? cb : RowCopy(wd * E, g.vb, (long long)N * E, g.ldb * E, nt))(
          reinterpret_cast<char*>(bs + s0), reinterpret_cast<const char*>(B + col), bn);
    else                                             // wd weight rows of bn
      cb(reinterpret_cast<char*>(bs + (size_t)s0 * g.ldb),
         reinterpret_cast<const char*>(B + (size_t)col * K), wd);
  };
  auto fetch = [&](int j) {
    if (j < jobs) {
      T* as = stage + (j % SUM_NS) * g.stage;
      T* bs = as + TM * g.lda;
      if (g.nrc > 1) {                               // a chunk of one head
        if (++fe == g.nrc) {
          fe = 0;
          do ++fh; while (mk[fh] == 0.f);
        }
        const int e0 = fe * SUM_RC;
        piece(as, bs, 0, fh * hd + e0, min(SUM_RC, hd - e0));
      } else {                                       // up to P heads, a run of
        for (int p = 0; p < g.P && left > 0;) {      // consecutive ones a piece
          do ++fh; while (mk[fh] == 0.f);
          const int f = fh, most = min(g.P - p, left);
          if (g.seg == hd)                           // segments hd apart: hd % 4 == 0
            while (fh - f + 1 < most && mk[fh + 1] != 0.f) ++fh;
          const int run = fh - f + 1;
          piece(as, bs, p * g.seg, f * hd, run * hd);
          p += run;
          left -= run;
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");     // empty groups too
  };
  float acc[RM][RN] = {}, part[RM][RN] = {};
  for (int j = 0; j < SUM_NS - 1; ++j) fetch(j);
  for (int j = 0, ce = 0, done = 0; j < jobs; ++j) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(SUM_NS - 2) : "memory");
    __syncthreads();                                 // job j landed, j - 1 consumed
    fetch(j + SUM_NS - 1);
    const T* as = stage + (j % SUM_NS) * g.stage + rg * g.lda;
    const T* bs = stage + (j % SUM_NS) * g.stage + TM * g.lda + (TRANS ? cg * g.ldb : cg * 4);
    const int np = min(g.P, kept - done);
    for (int p = 0, s0 = 0; p < np; ++p, s0 += g.seg) {
      mm_chunk<T, TRANS, RM, RN>(as + s0, RG * g.lda, bs + (TRANS ? s0 : s0 * g.ldb), g.ldb,
                                 TRANS ? g.ncg * g.ldb : g.ncg * 4,
                                 min(SUM_RC, hd - ce * SUM_RC), part);
      if (++ce < g.nrc) break;                       // more chunks of this head
      ce = 0;                                        // the head is done: head order
      ++done;
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int k = 0; k < RN; ++k) {
          acc[i][k] += part[i][k];
          part[i][k] = 0.f;
        }
    }
  }
  store_tile<T, TRANS, RM, RN>(out + ((size_t)c * M + m0) * K + n0, K, rows, bn, rg, RG, cg,
                               g.ncg, K % 4 == 0 && n0 % 4 == 0, acc);
}

// grid (cs, chunks x H, C), clusters (cs, 1, 1): a cluster per (client,
// head, chunk of the slab); block q takes m-tiles q, q + cs, ... Each
// m-tile's rows come through the cp.async ring (later stages in flight
// while one is computed); warp g sums rows g, g + 8, ... of it, each lane
// an 8x4 register tile of the chunk, so three 16-byte (fp32) shared loads
// feed 32 FMAs. The warps' sums are added in warp order into plane 0: the
// m-tile's partial. Each block pushes its partial, in float4s, to the slot
// of its tile in the block that sums each share of the chunk; after one
// cluster barrier every block adds the round's slots of its share in tile
// order onto its running fp32 totals (acc = p0, + p1, ...). A second
// barrier comes only between rounds, before slots are rewritten: no block
// writes a peer's shared memory after the last one, so every block may
// then exit. Every block of a cluster shares (c, h), so a dropped head's exit is
// cluster-uniform and comes before any barrier; cs <= T, so every block
// has a tile in round 0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
head_dw_kernel(DwArgs a, DwGeom g, const float* __restrict__ mask, int M, int H) {
  extern __shared__ __align__(16) unsigned char dw_sm[];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int q = (int)cluster.block_rank(), cs = g.cs, tid = threadIdx.x;
  const int h = blockIdx.y, chunk = blockIdx.x / cs, c = blockIdx.z;
  const int CJ = 1 << g.cj_log, CI = g.ci;
  const int i0 = chunk / g.ncj * CI * MI, j0 = chunk % g.ncj * CJ * MJ;
  const int bi = min(CI * MI, a.I - i0), bj = min(CJ * MJ, a.J - j0);
  const int grp = tid / UT, lane = tid % UT;
  const int li = (lane >> g.cj_log) * MI, lj = (lane & (CJ - 1)) * MJ;
  const int f0 = q * g.share, nf = min(g.share, NF - f0);   // this block's share
  T* out = static_cast<T*>(a.out) + c * a.oc + h * a.ho + (long long)i0 * a.ldo + j0;

  const int stage_elems = RS * (g.sl + g.sr);
  T* stage = reinterpret_cast<T*>(dw_sm);
  float* plane = reinterpret_cast<float*>(dw_sm + (size_t)NST * stage_elems * sizeof(T));
  float* slots = plane + GR * NF;                  // cs slots of g.share partials
  const T* Lg = static_cast<const T*>(a.L) + (size_t)c * M * a.ldl + (size_t)h * a.hl + i0;
  const T* Rg = static_cast<const T*>(a.R) + (size_t)c * M * a.ldr + (size_t)h * a.hr + j0;
  const int tiles = g.T > q ? (g.T - q + cs - 1) / cs : 0, jobs = tiles * SUB;

  // job j: stage j % SUB of this block's (j / SUB)-th m-tile; its first row
  // and its row count (0 past the end of a ragged last tile)
  auto job_rows = [&](int j, int& r0) {
    r0 = ((j / SUB) * cs + q) * MT + (j % SUB) * RS;
    return max(0, min(RS, M - r0));
  };
  auto fetch = [&](int j) {
    if (j < jobs) {
      int r0;
      const int n = job_rows(j, r0);
      T* ls = stage + (j % NST) * stage_elems;
      RowCopy(bi * (int)sizeof(T), g.vl, (long long)a.ldl * sizeof(T), g.sl * (int)sizeof(T))(
          reinterpret_cast<char*>(ls), reinterpret_cast<const char*>(Lg + (size_t)r0 * a.ldl), n);
      RowCopy(bj * (int)sizeof(T), g.vr, (long long)a.ldr * sizeof(T), g.sr * (int)sizeof(T))(
          reinterpret_cast<char*>(ls + RS * g.sl),
          reinterpret_cast<const char*>(Rg + (size_t)r0 * a.ldr), n);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");   // empty groups too
  };
  // output f of the chunk: element f / UT (row-major) of lane f % UT's tile
  auto store = [&](int f, float v) {
    const int l = f % UT, e = f / UT;
    const int i = (l >> g.cj_log) * MI + e / MJ, j = (l & (CJ - 1)) * MJ + e % MJ;
    if (i < bi && j < bj) out[(size_t)i * a.ldo + j] = rt::from_f<T>(v);
  };

  for (int j = 0; j < NST - 1; ++j) fetch(j);     // in flight while the mask is read
  if (mask[(size_t)c * H + h] == 0.f) {              // dropped: exact zeros
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int f = f0 + tid; f < f0 + nf; f += THREADS) store(f, 0.f);
    return;
  }
  const bool active = li < bi && lj < bj;
  float total[SHARE];
#pragma unroll
  for (int m = 0; m < SHARE; ++m) total[m] = 0.f;
  const int rounds = (g.T + cs - 1) / cs;
  for (int k = 0, j = 0; k < rounds; ++k) {
    if (k > 0) cluster.sync();                     // owners are done reading the slots
    if (k * cs + q < g.T) {                        // this block's m-tile of the round
      float acc[MI][MJ] = {};
      for (int s = 0; s < SUB; ++s, ++j) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(NST - 2) : "memory");
        __syncthreads();                           // stage j landed, j - 1 consumed
        fetch(j + NST - 1);
        int r0;
        const int n = job_rows(j, r0);
        if (active) {
          const T* lp = stage + (j % NST) * stage_elems + li;
          const T* rp = stage + (j % NST) * stage_elems + RS * g.sl + lj;
#pragma unroll 2
          for (int r = grp; r < n; r += GR) {
            float lv[MI], rv[MJ];
            load8(lp + r * g.sl, lv);
            load4(rp + r * g.sr, rv);
#pragma unroll
            for (int x = 0; x < MI; ++x)
#pragma unroll
              for (int y = 0; y < MJ; ++y) acc[x][y] = fmaf(lv[x], rv[y], acc[x][y]);
          }
        }
      }
#pragma unroll
      for (int x = 0; x < MI; ++x)
#pragma unroll
        for (int y = 0; y < MJ; ++y) plane[grp * NF + (x * MJ + y) * UT + lane] = acc[x][y];
      __syncthreads();
#pragma unroll
      for (int m = 0; m < SHARE; ++m) {              // the warps' sums, warp order
        const int f = tid + m * THREADS;
        float p = plane[f];
#pragma unroll
        for (int w = 1; w < GR; ++w) p += plane[w * NF + f];
        plane[f] = p;
      }
      __syncthreads();
      const int f = tid * 4, owner = f / g.share;  // push to the owner's slot q
      *reinterpret_cast<float4*>(cluster.map_shared_rank(slots, owner) + q * g.share +
                                 (f - owner * g.share)) =
          *reinterpret_cast<const float4*>(plane + f);
    }
    cluster.sync();                                // the round's partials are in place
    const int np = min(cs, g.T - k * cs);          // m-tiles of the round
#pragma unroll
    for (int m = 0; m < SHARE; ++m) {
      const int f = tid + m * THREADS;
      if (f < nf) {
        float t = total[m];
#pragma unroll
        for (int p = 0; p < MAX_CLUSTER; ++p)      // tile order
          if (p < np) {
            const float v = slots[p * g.share + f];
            t = (k == 0 && p == 0) ? v : t + v;
          }
        total[m] = t;
      }
    }
  }
#pragma unroll
  for (int m = 0; m < SHARE; ++m) {
    const int f = tid + m * THREADS;
    if (f < nf) store(f0 + f, total[m]);
  }
}

template <typename T, bool TRANS, int TM, int RM, int RN>
cudaError_t run_slab(const void* in, const void* w, const float* mask, void* out, int C,
                     int M, int K, int H, int hd, MmGeom& g, cudaStream_t s) {
  const int elem = sizeof(T), N = H * hd;
  g.va = copy_bytes(elem, K, SLAB_RC, K, K);
  g.vb = TRANS ? g.va : copy_bytes(elem, N, hd, g.bn, hd);
  cudaError_t err = allow_smem(head_slab_kernel<T, TRANS, TM, RM, RN>, g.smem);
  if (err != cudaSuccess) return err;
  const int ny = g.nch > 1 ? H * g.nch : (H + g.G - 1) / g.G;
  head_slab_kernel<T, TRANS, TM, RM, RN>
      <<<dim3((M + TM - 1) / TM, ny, C), g.threads, g.smem, s>>>(
          static_cast<const T*>(in), static_cast<const T*>(w), mask,
          static_cast<T*>(out), M, K, H, hd, g);
  return cudaGetLastError();
}

template <typename T, bool TRANS>
cudaError_t launch_slab(const void* in, const void* w, const float* mask,
                        void* out, int C, int M, int K, int H, int hd,
                        cudaStream_t s) {
  if (C == 0 || M == 0) return cudaSuccess;
  MmGeom g;
  int large;
  mm_pick(g, large, true, TRANS, C, M, K, H, hd, sizeof(T));
  constexpr Tile L = SLAB_LARGE, S = SLAB_SMALL;
  return large ? run_slab<T, TRANS, L.TM, L.RM, L.RN>(in, w, mask, out, C, M, K, H, hd, g, s)
               : run_slab<T, TRANS, S.TM, S.RM, S.RN>(in, w, mask, out, C, M, K, H, hd, g, s);
}

template <typename T, bool TRANS, int TM, int RM, int RN>
cudaError_t run_sum(const void* in, const void* w, const float* mask, void* out, int C,
                    int M, int K, int H, int hd, MmGeom& g, cudaStream_t s) {
  const int elem = sizeof(T), N = H * hd;
  g.va = copy_bytes(elem, N, hd, SUM_RC, hd);
  g.vb = TRANS ? g.va : copy_bytes(elem, K, g.bn, K, K);
  cudaError_t err = allow_smem(head_sum_kernel<T, TRANS, TM, RM, RN>, g.smem);
  if (err != cudaSuccess) return err;
  head_sum_kernel<T, TRANS, TM, RM, RN>
      <<<dim3((M + TM - 1) / TM, g.nch, C), g.threads, g.smem, s>>>(
          static_cast<const T*>(in), static_cast<const T*>(w), mask,
          static_cast<T*>(out), M, K, H, hd, g);
  return cudaGetLastError();
}

template <typename T, bool TRANS>
cudaError_t launch_sum(const void* in, const void* w, const float* mask,
                       void* out, int C, int M, int K, int H, int hd,
                       cudaStream_t s) {
  if (C == 0 || M == 0) return cudaSuccess;
  MmGeom g;
  int large;
  mm_pick(g, large, false, TRANS, C, M, K, H, hd, sizeof(T));
  constexpr Tile L = SUM_LARGE, S = SUM_SMALL;
  return large ? run_sum<T, TRANS, L.TM, L.RM, L.RN>(in, w, mask, out, C, M, K, H, hd, g, s)
               : run_sum<T, TRANS, S.TM, S.RM, S.RN>(in, w, mask, out, C, M, K, H, hd, g, s);
}

template <typename T>
cudaError_t launch_dw(const DwArgs& a, const float* mask, int C, int M, int H,
                      cudaStream_t s) {
  if (C == 0) return cudaSuccess;
  const int elem = sizeof(T);
  DwGeom g = dw_geom(M, a.I, a.J, elem);
  g.vl = copy_bytes(elem, a.ldl, a.hl, g.ci * MI, a.I);
  g.vr = copy_bytes(elem, a.ldr, a.hr, (1 << g.cj_log) * MJ, a.J);
  cudaError_t err = allow_smem(head_dw_kernel<T>, g.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = g.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  // a cluster's cs blocks are consecutive along x, the slab's chunks
  // follow them there (up to 2^31 - 1 blocks; y and z stop at 65535)
  cfg.gridDim = dim3(g.cs * g.nci * g.ncj, H, C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, head_dw_kernel<T>, a, g, mask, M, H);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// All pointers are device pointers of row-major arrays of type `dtype`
// (mask: (C, H) fp32). M rows per client; `width` is the non-head width
// (din for the projection, d for the merge); N = H·hd. Each returns
// cudaGetLastError() after its one launch (an error also where the
// launch needs more shared memory than a block may have); none allocates
// or synchronises.
// The slab (body 0) and sum (body 1) kernels' launch for C clients of M
// rows, `width` (din or d), H heads of hd, fp32; trans picks merge da
// (slab) or proj dx (sum). out[0] all blocks, out[1] threads a block,
// out[2] dynamic shared memory in bytes, out[3] heads a block (slab),
// out[4] 1 where the launch takes the large tile.
extern "C" void masked_attn_mm_geometry(int body, int trans, int C, int M,
                                        int width, int H, int hd, int* out) {
  MmGeom g;
  out[0] = (int)mm_pick(g, out[4], body == kSlab, trans != 0, C, M, width, H, hd,
                        sizeof(float));
  out[1] = g.threads;
  out[2] = g.smem;
  out[3] = g.G;
}

// The dW kernels' launch for C clients of M rows, H heads and an I x J
// slab: out[0] the blocks of a cluster, out[1] all blocks, out[2] m-tiles.
extern "C" void masked_attn_dw_geometry(int C, int M, int H, int I, int J,
                                        int* out) {
  const DwGeom g = dw_geom(M, I, J, sizeof(float));
  out[0] = g.cs;
  out[1] = g.cs * g.nci * g.ncj * H * C;
  out[2] = g.T;
}

// y (C, M, N) = x (C, M, din) · w (C, din, N), dropped heads' columns 0.
extern "C" int masked_head_proj_launch(const void* x, const void* w,
                                       const float* mask, void* y, int C, int M,
                                       int din, int H, int hd, int dtype,
                                       void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_slab<T, false>(x, w, mask, y, C, M, din, H, hd,
                                 static_cast<cudaStream_t>(stream));
  });
  return rt::cleared(err);
}

// dx (C, M, din) = Σ_kept h gy[:, h] (C, M, N) · w[:, h]ᵀ, w (C, din, N).
extern "C" int masked_head_proj_dx_launch(const void* gy, const void* w,
                                          const float* mask, void* dx, int C,
                                          int M, int din, int H, int hd,
                                          int dtype, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_sum<T, true>(gy, w, mask, dx, C, M, din, H, hd,
                               static_cast<cudaStream_t>(stream));
  });
  return rt::cleared(err);
}

// dw (C, din, N): dw[:, h] = Σ_tiles x_tᵀ · gy_t[:, h]; gy (C, M, N),
// x (C, M, din); dropped heads' columns 0.
extern "C" int masked_head_proj_dw_launch(const void* gy, const void* x,
                                          const float* mask, void* dw, int C,
                                          int M, int din, int H, int hd,
                                          int dtype, void* stream) {
  const int N = H * hd;
  DwArgs a{x, gy, dw, din, 0, N, hd, din, hd, N, hd, (long long)din * N};
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_dw<T>(a, mask, C, M, H, static_cast<cudaStream_t>(stream));
  });
  return rt::cleared(err);
}

// y (C, M, d) = Σ_kept h a[:, h] (C, M, N) · w[h, :], w (C, N, d).
extern "C" int masked_head_merge_launch(const void* a, const void* w,
                                        const float* mask, void* y, int C,
                                        int M, int d, int H, int hd, int dtype,
                                        void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_sum<T, false>(a, w, mask, y, C, M, d, H, hd,
                                static_cast<cudaStream_t>(stream));
  });
  return rt::cleared(err);
}

// da (C, M, N): da[:, h] = gy (C, M, d) · w[h, :]ᵀ, w (C, N, d); dropped
// heads' columns 0.
extern "C" int masked_head_merge_da_launch(const void* gy, const void* w,
                                           const float* mask, void* da, int C,
                                           int M, int d, int H, int hd,
                                           int dtype, void* stream) {
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_slab<T, true>(gy, w, mask, da, C, M, d, H, hd,
                                static_cast<cudaStream_t>(stream));
  });
  return rt::cleared(err);
}

// dw (C, N, d): dw[h, :] = Σ_tiles a_t[:, h]ᵀ · gy_t; gy (C, M, d),
// a (C, M, N); dropped heads' rows 0.
extern "C" int masked_head_merge_dw_launch(const void* gy, const void* a,
                                           const float* mask, void* dw, int C,
                                           int M, int d, int H, int hd,
                                           int dtype, void* stream) {
  const int N = H * hd;
  DwArgs args{a, gy, dw, N, hd, d, 0, hd, d, d, (long long)hd * d,
              (long long)N * d};
  cudaError_t err = cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    err = launch_dw<T>(args, mask, C, M, H, static_cast<cudaStream_t>(stream));
  });
  return rt::cleared(err);
}
