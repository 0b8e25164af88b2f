// Single-token grouped-query attention over a ragged KV cache, for Hopper
// (sm_90a). Replaces the Pallas kernel repro/kernels/decode_gqa.py::_kernel.
//
//   out[b, h] = softmax(q[b, h] · k[b, :len_b, h / G]ᵀ / sqrt(hd)) · v[b, :len_b, h / G]
//
// with the Pallas kernel's arithmetic: fp32 scores, softmax statistics and
// p·V in fp32, and out = acc / max(l, 1e-30) in the query's type.
//
// What bounds it on an H100: each K/V row of the valid prefix is read once
// and used by G query heads, so a call moves 2·Σ len_b·KV·hd·2 B in bf16
// and does ~4·G FLOPs per cached element. Bytes bound it: 6.55 MB, 1.96 us,
// at the serve's decode step (B 8, KV 8, hd 128, lengths 144–256), and the
// cache is cold there, read after a layer's weights have streamed through
// the 50 MB L2. A block that walks a whole prefix alone waits on a chain of
// memory round trips, and (KV, B) blocks leave most of the 132 SMs idle.
//
// Query heads a K/V head serves (G = H / KV) go to split blocks in virtual
// groups of VG ∈ {1, 2, 4, 8} heads, the largest that divides G; a K/V head
// then has REP = G / VG groups, each a block of its own that reads the same
// K/V rows (Granite-20B's MQA, 48 heads on one: 6 groups of 8). A group of
// at most 8 fills the n8 side of the score MMA. REP is 1 for G ≤ 8, and
// those launches are the ones without virtual groups, bit for bit.
//
// Design: the cache axis is split across blocks, flash-decoding style.
//   1. split: one block per (split of TS positions, virtual group, batch row),
//      TS chosen at launch so the grid covers the SMs several times. A
//      block whose split starts at or past len_b returns. Otherwise it
//      issues every 16-byte cp.async of its split's K rows (swizzled) and
//      then of its V rows, and waits for K alone. In bf16 the scores come
//      from mma.sync m16n8k16: 16 positions by the G heads (padded to 8)
//      over hd, products exact and sums fp32 as FFMA would give them, but
//      without the chain of warp-shuffle sums a dot product per lane group
//      costs (fp32 keeps FFMA and shuffles). Each warp takes the softmax
//      statistics of its own heads while V lands. p·V is fp32 FFMA: a thread
//      owns some columns of one head and sums the split's positions in order,
//      so nothing is combined across threads. It writes the split's max m_s,
//      sum l_s and acc_s[G][hd] to scratch.
//   2. merge: one block per (head, batch row), one thread a column, reads
//      the ⌈len_b / TS⌉ valid partials of its row in split order: m = max
//      m_s, l = Σ l_s·e^(m_s − m), acc = Σ acc_s·e^(m_s − m), out = acc /
//      max(l, 1e-30). A split with any valid position has a finite m_s, so
//      −1e30 never reaches an exponent. No atomics: two calls give the same
//      bits. It is a programmatic dependent launch: its blocks are resident
//      before the split grid ends and wait at griddepcontrol.wait, which
//      hides the second launch's latency.
// Nothing is allocated here: the caller passes the fp32 scratch.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_MERGE_THREADS = 256;   // merge threads: max(hd, 32)
constexpr int PRE = 8;                   // merge: partials a thread loads at once
constexpr float NEG = -1e30f;
constexpr size_t STATIC_SMEM = 48 * 1024;
constexpr size_t MAX_SMEM = 227 * 1024;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

// Dynamic shared memory of a split block: K and V tiles (TS x hd of T)
// and the scores (G x TS fp32).
size_t split_smem(int ts, int hd, int G, int elem) {
  return (size_t)2 * ts * hd * elem + (size_t)G * ts * 4;
}

// 16-byte chunk c of cached row j lies at chunk kchunk(j, c) of its row in
// shared memory: rows of 128 bytes or more are swizzled, so the 8 rows an
// ldmatrix reads fall in 8 different bank groups.
template <int LPG>
__device__ __forceinline__ int kchunk(int j, int c) {
  return LPG >= 8 ? (c ^ (j & 7)) : c;
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// d += a·b: a 16x16 bf16 (row), b 16x8 bf16 (col), d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N consecutive elements from shared memory, in the widest loads their
// alignment (N·sizeof(T) bytes from a multiple of it) allows.
template <typename T, int N>
__device__ __forceinline__ void load_cols(const T* p, T (&e)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i)
      reinterpret_cast<uint4*>(e)[i] = reinterpret_cast<const uint4*>(p)[i];
  } else if constexpr (BYTES == 8) {
    *reinterpret_cast<uint2*>(e) = *reinterpret_cast<const uint2*>(p);
  } else if constexpr (BYTES == 4) {
    *reinterpret_cast<unsigned*>(e) = *reinterpret_cast<const unsigned*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = p[i];
  }
}

// Partials: acc (B, KVV, S, G, hd) then (m, l) pairs (B, KVV, S, G, 2),
// fp32, over the KVV = KV·rep virtual groups of G heads (gridDim.y).
// A cache row is LPG 16-byte chunks (hd = LPG·16 / sizeof(T)).
template <typename T, int G, int LPG>
__global__ void __launch_bounds__(THREADS)
gqa_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ lengths,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int C, int KV, int rep, int ts, float scale) {
  constexpr int V = rt::Vec<T>::N;
  constexpr int HD = LPG * V;
  // bf16 scores on the tensor cores: products of bf16 values are exact in
  // fp32 and the sums fp32, as FFMA gives them, without the shuffle sums
  constexpr bool MMA = std::is_same<T, __nv_bfloat16>::value && HD % 16 == 0;
  constexpr int TPH = THREADS / G;                     // p·V threads a head
  constexpr int CPT = HD > TPH ? HD / TPH : 1;         // p·V columns a thread
  extern __shared__ __align__(16) char smem[];
  // vg: this block's virtual group of G heads, all on K/V head kh
  const int s = blockIdx.x, vg = blockIdx.y, b = blockIdx.z, S = gridDim.x;
  const int KVV = gridDim.y, kh = vg / rep;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");   // the merge may start
  const int len = min(lengths[b], C);
  const int t0 = s * ts;
  if (t0 >= len) return;
  const int n = min(ts, len - t0);

  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + (size_t)ts * HD;
  float* sp = reinterpret_cast<float*>(sv + (size_t)ts * HD);   // (G, ts)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // one round trip: every K row of the split, then every V row
  const size_t pos_stride = (size_t)KV * HD;
  const T* kb = k + ((size_t)b * C * KV + kh) * HD + (size_t)t0 * pos_stride;
  const T* vb = v + ((size_t)b * C * KV + kh) * HD + (size_t)t0 * pos_stride;
  for (int e = tid; e < n * LPG; e += THREADS) {
    const int j = e / LPG, c = e % LPG;
    cp_async16(sk + (j * LPG + kchunk<LPG>(j, c)) * V, kb + (size_t)j * pos_stride + c * V);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int e = tid; e < n * LPG; e += THREADS)
    cp_async16(sv + e * V, vb + (size_t)(e / LPG) * pos_stride + (e % LPG) * V);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const T* qb = q + ((size_t)b * KVV * G + vg * G) * HD;

  if constexpr (MMA) {
    // S^T (16 positions x 8 heads) = K tile (16 x hd) · Q^T (hd x 8, heads
    // past G zero); warp w takes position tiles w, w + WARPS, ...
    unsigned qf[HD / 16][2];
    const int gq = lane / 4, kq = 2 * (lane % 4);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qf[kk][0] = gq < G ? *reinterpret_cast<const unsigned*>(qb + gq * HD + kk * 16 + kq) : 0u;
      qf[kk][1] = gq < G ? *reinterpret_cast<const unsigned*>(qb + gq * HD + kk * 16 + kq + 8)
                         : 0u;
    }
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // K has landed
    __syncthreads();
    for (int pt = warp; pt * 16 < n; pt += WARPS) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      const int mi = lane >> 3, row = pt * 16 + (lane & 7) + (mi & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned a[4];
        ldsm_x4(a, sk + (row * LPG + kchunk<LPG>(row, kk * 2 + (mi >> 1))) * V);
        mma_bf16(d, a, qf[kk][0], qf[kk][1]);
      }
      const int j = pt * 16 + gq, g = kq;          // d: (j, g), (j, g+1), (j+8, g), (j+8, g+1)
      if (g < G && j < n) sp[g * ts + j] = d[0] * scale;
      if (g + 1 < G && j < n) sp[(g + 1) * ts + j] = d[1] * scale;
      if (g < G && j + 8 < n) sp[g * ts + j + 8] = d[2] * scale;
      if (g + 1 < G && j + 8 < n) sp[(g + 1) * ts + j + 8] = d[3] * scale;
    }
  } else {
    // LPG lanes a position, shuffle sums; every lane runs the same trip
    // count so the shuffles converge
    constexpr int NG = THREADS / LPG;
    const int grp = tid / LPG, lig = tid % LPG;
    float qv[G][V];
#pragma unroll
    for (int g = 0; g < G; ++g) rt::load16(qb + g * HD + lig * V, qv[g]);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");   // K has landed
    __syncthreads();
#pragma unroll 2
    for (int j0 = 0; j0 < n; j0 += NG) {
      const int j = j0 + grp;
      float e[V];
      if (j < n) {
        const uint4 raw =
            *reinterpret_cast<const uint4*>(sk + (j * LPG + kchunk<LPG>(j, lig)) * V);
        const T* el = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) e[i] = rt::to_f(el[i]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) e[i] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sc = 0.f;
#pragma unroll
        for (int i = 0; i < V; ++i) sc = fmaf(qv[g][i], e[i], sc);
#pragma unroll
        for (int off = LPG / 2; off > 0; off >>= 1)
          sc += __shfl_xor_sync(0xffffffffu, sc, off);
        if (lig == 0 && j < n) sp[g * ts + j] = sc * scale;
      }
    }
  }
  __syncthreads();

  // the split's softmax statistics, each warp its own heads
  for (int g = warp; g < G; g += WARPS) {
    float mx = NEG;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sp[g * ts + j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sp[g * ts + j] - mx);
      sp[g * ts + j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      float* ml = part_ml + ((((size_t)b * KVV + vg) * S + s) * G + g) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");   // V has landed
  __syncthreads();

  // p·V in fp32: thread t owns CPT columns of head t / TPH over all of the
  // split's positions, summed in position order; nothing to combine after
  const int g = tid / TPH, c0 = (tid % TPH) * CPT;
  if (c0 >= HD) return;
  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;
  const float* pg = sp + g * ts;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float p = pg[j];
    alignas(16) T e[CPT];
    load_cols<T, CPT>(sv + (size_t)j * HD + c0, e);
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[i] = fmaf(p, rt::to_f(e[i]), acc[i]);
  }
  float* dst = part_acc + ((((size_t)b * KVV + vg) * S + s) * G + g) * HD + c0;
#pragma unroll
  for (int i = 0; i < CPT; ++i) dst[i] = acc[i];
}

// grid (H, B), max(hd, 32) threads: thread dd of block (h, b) writes
// out[b, h, dd]; KV and G here are the virtual groups and their heads.
// Launched as a programmatic dependent of the split kernel: it waits for
// the split grid's writes at griddepcontrol.wait.
template <typename T>
__global__ void __launch_bounds__(MAX_MERGE_THREADS)
gqa_merge_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                 const int* __restrict__ lengths, T* __restrict__ out, int C, int KV,
                 int G, int hd, int ts, int S) {
  extern __shared__ float sw[];              // the splits' m_s, then their weights; l_s
  float* sl = sw + S;
  __shared__ float s_l;
  const int h = blockIdx.x, b = blockIdx.y, kh = h / G, g = h % G;
  const int tid = threadIdx.x;
  const int len = min(lengths[b], C);
  const int ns = (len + ts - 1) / ts;        // valid splits, in order
  const size_t row = (size_t)b * KV + kh;
  const float* ml = part_ml + row * S * G * 2;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  // the first PRE splits' partials of this column, loaded beside the (m, l)
  const float* acc = part_acc + (row * S * G + g) * hd + tid;
  float pre[PRE];
#pragma unroll
  for (int s = 0; s < PRE; ++s) pre[s] = tid < hd && s < ns ? acc[(size_t)s * G * hd] : 0.f;
  if (tid < 32) {                            // m = max m_s; w_s = e^(m_s - m); l in order
    float m = NEG;
    for (int s = tid; s < ns; s += 32) {
      const float2 p = *reinterpret_cast<const float2*>(ml + (s * G + g) * 2);
      sw[s] = p.x;
      sl[s] = p.y;
      m = fmaxf(m, p.x);
    }
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    for (int s = tid; s < ns; s += 32) sw[s] = expf(sw[s] - m);
    __syncwarp();
    if (tid == 0) {
      float l = 0.f;
      for (int s = 0; s < ns; ++s) l = fmaf(sl[s], sw[s], l);
      s_l = l;
    }
  }
  __syncthreads();
  if (tid >= hd) return;
  float a = 0.f;
#pragma unroll
  for (int s = 0; s < PRE; ++s)
    if (s < ns) a = fmaf(pre[s], sw[s], a);
  for (int s = PRE; s < ns; ++s) a = fmaf(acc[(size_t)s * G * hd], sw[s], a);
  out[((size_t)b * KV * G + h) * hd + tid] = rt::from_f<T>(a / fmaxf(s_l, 1e-30f));
}

template <typename T, int G, int LPG>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, float* scratch, int B, int KV,
                   int rep, int C, int hd, int ts, float scale, cudaStream_t s) {
  const int S = (C + ts - 1) / ts;
  const int KVV = KV * rep;                 // virtual groups of G heads
  float* part_acc = scratch;
  float* part_ml = scratch + (size_t)B * KVV * S * G * hd;
  const size_t smem = split_smem(ts, hd, G, sizeof(T));
  if (smem > MAX_SMEM || hd > MAX_MERGE_THREADS || ts % 16) return cudaErrorInvalidValue;
  static size_t allowed = STATIC_SMEM;      // per instance: raised once, kept
  if (smem > allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        gqa_split_kernel<T, G, LPG>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  gqa_split_kernel<T, G, LPG><<<dim3(S, KVV, B), THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, part_acc, part_ml, C, KV, rep, ts, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(KVV * G, B);
  cfg.blockDim = dim3(hd < 32 ? 32 : hd);
  cfg.dynamicSmemBytes = (size_t)2 * S * sizeof(float);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gqa_merge_kernel<T>, static_cast<const float*>(part_acc),
                           static_cast<const float*>(part_ml), lengths, static_cast<T*>(out),
                           C, KVV, G, hd, ts, S);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, int G>
cudaError_t dispatch_lanes(const void* q, const void* k, const void* v, const int* lengths,
                           void* out, float* scratch, int B, int KV, int rep, int C, int hd,
                           int ts, float scale, int lanes, cudaStream_t s) {
  switch (lanes) {
    case 1: return launch<T, G, 1>(q, k, v, lengths, out, scratch, B, KV, rep, C, hd, ts, scale, s);
    case 2: return launch<T, G, 2>(q, k, v, lengths, out, scratch, B, KV, rep, C, hd, ts, scale, s);
    case 4: return launch<T, G, 4>(q, k, v, lengths, out, scratch, B, KV, rep, C, hd, ts, scale, s);
    case 8: return launch<T, G, 8>(q, k, v, lengths, out, scratch, B, KV, rep, C, hd, ts, scale, s);
    case 16: return launch<T, G, 16>(q, k, v, lengths, out, scratch, B, KV, rep, C, hd, ts, scale, s);
    case 32: return launch<T, G, 32>(q, k, v, lengths, out, scratch, B, KV, rep, C, hd, ts, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// VG = G / rep heads a split block: 1, 2, 4 or 8
template <typename T>
cudaError_t dispatch_g(const void* q, const void* k, const void* v, const int* lengths,
                       void* out, float* scratch, int B, int KV, int rep, int C, int hd,
                       int ts, float scale, int G, int lanes, cudaStream_t s) {
  if (hd * (int)sizeof(T) != lanes * 16 || rep < 1 || G % rep) return cudaErrorInvalidValue;
  switch (G / rep) {
    case 1: return dispatch_lanes<T, 1>(q, k, v, lengths, out, scratch, B, KV, rep, C, hd, ts, scale, lanes, s);
    case 2: return dispatch_lanes<T, 2>(q, k, v, lengths, out, scratch, B, KV, rep, C, hd, ts, scale, lanes, s);
    case 4: return dispatch_lanes<T, 4>(q, k, v, lengths, out, scratch, B, KV, rep, C, hd, ts, scale, lanes, s);
    case 8: return dispatch_lanes<T, 8>(q, k, v, lengths, out, scratch, B, KV, rep, C, hd, ts, scale, lanes, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fp32 scratch a call needs: (B, H, ⌈C/ts⌉) partials of hd + 2 floats.
extern "C" long long decode_gqa_scratch_floats(int B, int H, int KV, int C,
                                               int hd, int ts) {
  return (long long)B * H * ((C + ts - 1) / ts) * (hd + 2);
}

// q (B,H,hd), k/v (B,C,KV,hd), out (B,H,hd): type `dtype`, contiguous,
// 16-byte aligned; lengths (B,) int32 in [1, C]; scratch of
// decode_gqa_scratch_floats(...) fp32. Requires H = KV·G with G = rep·VG,
// VG in {1, 2, 4, 8} (rep virtual groups of VG heads a K/V head), hd /
// (16 / sizeof(dtype)) a power of two <= 32, and ts (cache positions a
// split) >= 1. Two launches, split then merge, on `stream`. Returns the
// first nonzero cudaGetLastError().
extern "C" int decode_gqa_launch(const void* q, const void* k, const void* v,
                                 const int* lengths, void* out, float* scratch,
                                 int B, int H, int KV, int C, int hd, int ts, int rep,
                                 float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ts < 1 || H % KV) return cudaErrorInvalidValue;
  RT_DISPATCH(dtype, T, {
    return dispatch_g<T>(q, k, v, lengths, out, scratch, B, KV, rep, C, hd, ts, scale, H / KV,
                         hd * (int)sizeof(T) / 16, s);
  });
  return cudaGetLastError();
}
