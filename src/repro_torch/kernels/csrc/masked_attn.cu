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
// 0.27 MB for 4 MFLOP, 15 FLOP per byte, and a whole call at C 5 is a
// fraction of a microsecond of memory time: launch latency, the number of
// SMs in use and the serial dot products bound it. The slab and sum
// kernels stage a row tile's operands and the client's whole weight (16 KB)
// in shared memory once, with padded rows so the reads are bank-conflict
// free, and loop over the kept heads inside the block (several heads per
// program: hd 16 is far below a tile). fp32 FFMA throughout, so the sums
// are the plain version's up to order. The dW kernel splits each slab's
// m-tiles over several blocks, 80 blocks at C 5 where one block a slab gave
// 20; at C 64 its 1024 blocks are bound by a fixed latency chain each
// (mask, first stage, warp sums, push, barrier) and by staging the operand
// that all heads share once per head.
//
// Hopper has no sequential grid, so the Pallas accumulators revisited
// across the grid become loops inside one block or a fixed-order sum
// across the blocks of a cluster. The sum kernel adds each kept head's dot
// product to its fp32 total in head order. The dW kernel splits a (client,
// head) slab's 128-row m-tiles across a thread-block cluster of
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

constexpr int THREADS = 256;
constexpr int TM = 32;          // rows of a tile in the slab and sum kernels
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

enum Body : int { kSlab = 0, kSum = 1, kDw = 2 };

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

// Shared memory of each body, in bytes. kSlab: (K in width, N out width);
// kSum: (N in width, K out width); kDw: (I, J) of the output slab, fp32
// (bf16 stages take less).
size_t smem_bytes(int body, int w1, int w2) {
  if (body == kDw) return (size_t)dw_geom(1, w1, w2, sizeof(float)).smem;
  return sizeof(float) * ((size_t)TM * (w1 + 1) + (size_t)w1 * (w2 + 1));
}

template <typename Kern>
cudaError_t allow_smem(Kern* kern, size_t bytes) {
  if (bytes > MAX_SMEM) return cudaErrorInvalidValue;
  if (bytes <= STATIC_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// out[c][m][j] = Σ_k in[c][m][k]·B(k, j) for the columns j of kept heads,
// 0 for the columns of dropped heads; j < N = H·hd.
//   TRANS = false: B(k, j) = w[c][k][j], w (C, K, N)    (proj)
//   TRANS = true:  B(k, j) = w[c][j][k], w (C, N, K)    (merge da)
// grid (row tiles of TM, C). Shared: the row tile [TM][K+1] and the kept
// heads' columns of B [K][N+1].
template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS)
head_slab_kernel(const T* __restrict__ in, const T* __restrict__ w,
                 const float* __restrict__ mask, T* __restrict__ out, int M,
                 int K, int H, int hd) {
  extern __shared__ float sm[];
  const int N = H * hd, c = blockIdx.y, m0 = blockIdx.x * TM;
  const int rows = min(TM, M - m0), ldi = K + 1, ldw = N + 1, tid = threadIdx.x;
  float* is = sm;
  float* ws = sm + TM * ldi;
  const float* mk = mask + (size_t)c * H;
  const T* in_c = in + ((size_t)c * M + m0) * K;
  const T* w_c = w + (size_t)c * K * N;
  T* out_c = out + ((size_t)c * M + m0) * N;

  for (int e = tid; e < rows * K; e += THREADS)
    is[(e / K) * ldi + e % K] = rt::to_f(in_c[e]);
  for (int e = tid; e < K * N; e += THREADS) {      // coalesced along w's rows
    const int k = TRANS ? e % K : e / N, j = TRANS ? e / K : e % N;
    if (mk[j / hd] != 0.f) ws[k * ldw + j] = rt::to_f(w_c[e]);
  }
  __syncthreads();

  for (int h = 0; h < H; ++h) {
    const bool kept = mk[h] != 0.f;                  // block-uniform
    for (int o = tid; o < rows * hd; o += THREADS) {
      const int r = o / hd, j = h * hd + o % hd;
      float acc = 0.f;
      if (kept) {
        const float* ir = is + r * ldi;
#pragma unroll 8
        for (int k = 0; k < K; ++k) acc = fmaf(ir[k], ws[k * ldw + j], acc);
      }
      out_c[(size_t)r * N + j] = rt::from_f<T>(acc);
    }
  }
}

// out[c][m][k] = Σ over kept heads h, in order, of
//                Σ_e in[c][m][h·hd + e]·B(h·hd + e, k);   k < K.
//   TRANS = false: B(j, k) = w[c][j][k], w (C, N, K)    (merge)
//   TRANS = true:  B(j, k) = w[c][k][j], w (C, K, N)    (proj dx)
// grid (row tiles of TM, C). Shared: the row tile [TM][N+1] and the kept
// heads' rows of B [N][K+1].
template <typename T, bool TRANS>
__global__ void __launch_bounds__(THREADS)
head_sum_kernel(const T* __restrict__ in, const T* __restrict__ w,
                const float* __restrict__ mask, T* __restrict__ out, int M,
                int K, int H, int hd) {
  extern __shared__ float sm[];
  const int N = H * hd, c = blockIdx.y, m0 = blockIdx.x * TM;
  const int rows = min(TM, M - m0), ldi = N + 1, ldw = K + 1, tid = threadIdx.x;
  float* is = sm;
  float* ws = sm + TM * ldi;
  const float* mk = mask + (size_t)c * H;
  const T* in_c = in + ((size_t)c * M + m0) * N;
  const T* w_c = w + (size_t)c * K * N;
  T* out_c = out + ((size_t)c * M + m0) * K;

  for (int e = tid; e < rows * N; e += THREADS) {
    const int j = e % N;
    if (mk[j / hd] != 0.f) is[(e / N) * ldi + j] = rt::to_f(in_c[e]);
  }
  for (int e = tid; e < K * N; e += THREADS) {      // coalesced along w's rows
    const int j = TRANS ? e % N : e / K, k = TRANS ? e / N : e % K;
    if (mk[j / hd] != 0.f) ws[j * ldw + k] = rt::to_f(w_c[e]);
  }
  __syncthreads();

  for (int o = tid; o < rows * K; o += THREADS) {
    const int r = o / K, k = o % K;
    const float* ir = is + r * ldi;
    float acc = 0.f;
    for (int h = 0; h < H; ++h) {
      if (mk[h] == 0.f) continue;                    // block-uniform
      float part = 0.f;
      for (int e = h * hd; e < (h + 1) * hd; ++e)
        part = fmaf(ir[e], ws[e * ldw + k], part);
      acc += part;
    }
    out_c[(size_t)r * K + k] = rt::from_f<T>(acc);
  }
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
// shared sld). Thread tid starts at vector (r0, c0) of the flat order and
// steps by THREADS vectors as (dr, dc), so no index is divided in the loop.
struct RowCopy {
  int vb, vpr, r0, c0, dr, dc, sld;
  long long ld;
  __device__ RowCopy(int width_bytes, int vb_, long long ld_, int sld_)
      : vb(vb_), vpr(width_bytes / vb_), sld(sld_), ld(ld_) {
    r0 = threadIdx.x / vpr;
    c0 = threadIdx.x % vpr;
    dr = THREADS / vpr;
    dc = THREADS % vpr;
  }
  template <int B>
  __device__ void rows(char* dst, const char* src, int n) const {
    for (int r = r0, c = c0; r < n;) {
      copy_async<B>(dst + r * sld + c * B, src + r * ld + c * B);
      c += dc;
      r += dr;
      if (c >= vpr) { c -= vpr; ++r; }
    }
  }
  __device__ void operator()(char* dst, const char* src, int n) const {
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
  const int h = blockIdx.y % H, chunk = blockIdx.y / H, c = blockIdx.z;
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

template <typename T, bool TRANS>
cudaError_t launch_slab(const void* in, const void* w, const float* mask,
                        void* out, int C, int M, int K, int H, int hd,
                        cudaStream_t s) {
  if (C == 0 || M == 0) return cudaSuccess;
  const size_t smem = smem_bytes(kSlab, K, H * hd);
  cudaError_t err = allow_smem(head_slab_kernel<T, TRANS>, smem);
  if (err != cudaSuccess) return err;
  head_slab_kernel<T, TRANS><<<dim3((M + TM - 1) / TM, C), THREADS, smem, s>>>(
      static_cast<const T*>(in), static_cast<const T*>(w), mask,
      static_cast<T*>(out), M, K, H, hd);
  return cudaGetLastError();
}

template <typename T, bool TRANS>
cudaError_t launch_sum(const void* in, const void* w, const float* mask,
                       void* out, int C, int M, int K, int H, int hd,
                       cudaStream_t s) {
  if (C == 0 || M == 0) return cudaSuccess;
  const size_t smem = smem_bytes(kSum, H * hd, K);
  cudaError_t err = allow_smem(head_sum_kernel<T, TRANS>, smem);
  if (err != cudaSuccess) return err;
  head_sum_kernel<T, TRANS><<<dim3((M + TM - 1) / TM, C), THREADS, smem, s>>>(
      static_cast<const T*>(in), static_cast<const T*>(w), mask,
      static_cast<T*>(out), M, K, H, hd);
  return cudaGetLastError();
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
  cfg.gridDim = dim3(g.cs, g.nci * g.ncj * H, C);
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
// cudaGetLastError() after its one launch; none allocates or synchronises.
extern "C" long long masked_attn_smem_bytes(int body, int w1, int w2) {
  return (long long)smem_bytes(body, w1, w2);
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
  return err;
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
  return err;
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
  return err;
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
  return err;
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
  return err;
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
  return err;
}
