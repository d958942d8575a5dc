// Train-mode batch normalisation for Hopper (sm_90a): flax's formula in
// four kernels, which every process runs (models/batchnorm.py).
//
// Replaces no TPU kernel: the JAX package's BatchNorm is flax's
// nn.BatchNorm (segmentation_training_pipeline_tpu/models/layers.py),
// lowered by XLA.  It was added because the port ran two formulas, cuDNN's
// in one process and eager float64 sums under a process group, whose
// float32 roundings of an ill-conditioned stem gradient differ by more
// than the data-and-space step's bar; one formula needs one
// implementation, and eager ops cost the synced step 2.7-3x the plain one.
//
//   bn_stats       per channel s1 = sum x and s2 = sum x^2 of the float32
//                  values, accumulated in float64, and the count n
//                  (out: s1[C], s2[C], n)
//   bn_apply       mean = s1/n, var = max(s2/n - mean^2, 0), each rounded
//                  to float32; invstd = 1/sqrt(var + eps) (the sum in
//                  float32, the root correctly rounded); y = (x - mean) *
//                  (invstd * w) + b in float32, stored in x's type; mean
//                  and invstd saved for the backward; the running
//                  statistics blended with the biased var by the block
//                  that holds each channel's first slice
//   bn_grad_stats  g1 = sum dy and g2 = sum dy * (x - mean) in float64
//                  (out: g1[C], g2[C]), and from these local sums the
//                  bias's gradient g1 and the scale's g2 * invstd
//   bn_grad_apply  dx = (invstd * w) * ((dy - g1/n) - (x - mean) * c2),
//                  c2 = g2/n * invstd^2, from the (reduced) sums
//
// Under a process group the wrapper all-reduces (s1, s2, n) between the
// first two and (g1, g2) between the last two.  A null w is flax's
// use_scale=False (the scale is 1 and no gradient is written for it).
// float32, bfloat16 and float16 values compute in float32, float64 values
// in float64.  The build passes -fmad=false, so every product and sum rounds
// as in the plain PyTorch versions beside the wrapper; the sums' one
// written fused multiply-add takes a product that is exact (see mul_add).
//
// Layouts.  "planes": a contiguous NCHW tensor, each channel's N*H*W values
// in N runs of H*W.  "rows": the tensor as an (N*H*W, C) row-major matrix
// (channels-last, the port's layout on the card, or H*W = 1), cut into
// tiles of at most 512 channels through the ring (256 in float64 or one
// value at a time; up to that a tile is the whole row, so a run of rows is
// one run of bytes) or of 64 with direct loads.  A grid row of blocks takes a tile (rows) or a channel (planes),
// and walks on to the next one where the grid holds fewer of them.
//
// What bounds them on an H100: memory.  The forward reads x twice and
// writes y; the backward reads x and dy twice and writes dx.  The sums cost
// one or two float32-to-float64 conversions and two float64 operations a
// value, under half of what the card issues at the rate HBM delivers
// values.  What holds them back is latency and the cross-block sums: a
// block that waits on each of its loads, one block that adds hundreds of
// blocks' partials (as long as the stream on the middle maps), a channel's
// float64 coefficients computed in every thread before its first value.
// Where every pointer is 16-byte aligned and a row (or a plane) is a
// multiple of 16 bytes, the wrapper picks one of two ways to read a map
// (models/batchnorm.py:_mode):
//   - the ring, on large maps: one thread streams the block's stages
//     through four 8 KB slots in shared memory with cp.async.bulk and an
//     mbarrier a slot, which the block's threads read; rows' stages are
//     whole rows of the block's slice, planes' stages are dealt out across
//     the channel's blocks in turn (block s of S takes stages s, s + S, …),
//     so that the blocks of all channels sweep their planes together; the
//     reductions' threads each own two channels (one of float64 values)
//     across rows, so a thread keeps four float64 sums;
//   - direct 16-byte loads, on channels-last maps of a few MB and on wide
//     planes (bn_apply, bn_grad_stats): a block's few stages would not pay
//     for the ring's barriers, where loads issued at once by every thread
//     cover the latency; rows take tiles of 64 channels and eight rows a
//     thread, a thread one 16-byte vector's channels; a plane's thread
//     keeps two pairs of sums (two chains of float64 additions).
// Both end the same way:
//   - thread block clusters (the ring's reductions): the blocks of a
//     cluster (up to 8 along the slices) add their sums in the first block
//     through distributed shared memory, in rank order, so one partial a
//     cluster, not a block, goes to device memory; where one cluster
//     covers a tile there are no partials, no fence, no ticket and no
//     tail; else the last cluster to arrive shares the partials' sum among
//     its blocks, each a part of the tile's channels;
//   - the partition (slices, tiles, clusters) is the wrapper's, from the
//     shape alone, sized to one wave of an H100 80GB HBM3; the card's
//     occupancy sets only how many tiles run at once, and blocks walk on
//     to the next tile where the grid holds fewer;
//   - bn_apply computes each channel's coefficients once a block (one
//     thread a channel, into shared memory; through the ring while its
//     first stages load), and writes y with 16-byte stores.
// Elsewhere (a 6-byte row, a pointer off 16 bytes) the same blocks and
// sums read and write one value at a time, straight from device memory.
// bn_grad_apply keeps its first design: 16-byte accesses, four blocks an
// SM aimed at.
//
// Determinism.  Each sum runs in a fixed order: each thread its rows or
// vectors in order (a plane's two chains added at the end), the block's
// row groups (rows) or warps (planes) in order, the ranks of a cluster in
// rank order, then, where a tile has more than one cluster, each channel's
// clusters' partials in cluster order (in interleaved runs, then the runs
// in order), by whichever cluster arrives last (an atomic ticket after a
// __threadfence, reset for the next launch).  The order depends on the
// shape, the layout and the alignment alone, never on the card or on the
// blocks' schedule: every launch is bit-identical to the last.  The
// tickets are one zeroed buffer per device and stream that every launch
// leaves zeroed.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;          // the ring's stages
constexpr int kStageBytes = 8192;   // one stage, all of its tensors
constexpr int kMaxPieces = 32;      // bulk copies in one stage, at most
constexpr int kMaxCluster = 8;      // portable cluster size
constexpr int kMinBlocks = 4;       // resident blocks an SM the build aims at

// resident blocks an SM a kernel is built for: three where a thread keeps a
// 16-byte vector's sums (rows without the ring; four spill registers)
__host__ __device__ constexpr int min_blocks(bool rows, bool ring) {
  return rows && !ring ? 3 : kMinBlocks;
}

// Deliberately wrong builds that split the reductions' time
// (compare_kernels.py SOURCE:ABLATION passes -DSTP_BN_ABLATE_<ABLATION>):
// ONE_LEVEL, a cluster's first block finishes its cluster's sums (no
// partials, ticket or tail); NO_CLUSTER, each block finishes its own;
// EMPTY, the reductions return at once (the launch alone).
#if defined(STP_BN_ABLATE_ONE_LEVEL) || defined(STP_BN_ABLATE_NO_CLUSTER)
constexpr bool kAblateOneLevel = true;
#else
constexpr bool kAblateOneLevel = false;
#endif
#ifdef STP_BN_ABLATE_NO_CLUSTER
constexpr bool kAblateCluster = true;
#else
constexpr bool kAblateCluster = false;
#endif
#ifdef STP_BN_ABLATE_EMPTY
constexpr bool kAblateAll = true;
#else
constexpr bool kAblateAll = false;
#endif

template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

// channels a reduction thread sums from the ring in the rows layout: two
// values of 2 or 4 bytes (one 4- or 8-byte access), one of 8 bytes
__host__ __device__ constexpr int pairs(int width) {
  return width <= 4 ? 2 : 1;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }
__device__ __forceinline__ double widen(double v) { return v; }

__device__ __forceinline__ void narrow(float v, float* p) { *p = v; }
__device__ __forceinline__ void narrow(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void narrow(float v, __half* p) {
  *p = __float2half_rn(v);
}
__device__ __forceinline__ void narrow(double v, double* p) { *p = v; }

template <int B>
struct Raw;
template <>
struct Raw<4> {
  using type = uint32_t;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<16> {
  using type = uint4;
};

// N consecutive values: one access of N * sizeof(T) bytes when N > 1
template <typename T, int N, typename A>
__device__ __forceinline__ void load(const T* p, A (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = widen(p[0]);
  } else {
    using R = typename Raw<N * sizeof(T)>::type;
    R raw = *reinterpret_cast<const R*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = widen(e[k]);
  }
}

template <typename T, int N, typename A>
__device__ __forceinline__ void store(T* p, const A (&v)[N]) {
  if constexpr (N == 1) {
    narrow(v[0], p);
  } else {
    using R = typename Raw<N * sizeof(T)>::type;
    R raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < N; ++k) narrow(v[k], e + k);
    *reinterpret_cast<R*>(p) = raw;
  }
}

// ------------------------------------------------ bulk copies, barriers

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// the barrier's one arrival, expecting `bytes` of copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// ------------------------------------------------ geometry

struct Geo {
  long long outer;  // planes: images N; rows: rows N*H*W
  long long inner;  // planes: H*W; rows: 1
  long long span;   // a slice: rows (rows) or a channel's values (planes)
  int nc;           // channels
  int slices;       // blocks along a tile or channel (grid x)
  int tw;           // rows: channels per tile (bn_grad_apply, in shape_of:
                    // vector columns)
  int cluster;      // blocks of a cluster along the slices
  int items;        // grid y: tiles or channels at once (blocks walk on)
};

// A block's stages: [base + q·step, base + (q+1)·step) ∩ [.., end) in rows
// (rows) or values (planes) for q = first, first + stride, ….  Rows: the
// block's slice [u0, u1) in order (stride 1).  Planes: the stages of the
// whole channel, block s of `stride` taking s, s + stride, ….  A stage is
// at most `elems` values of each tensor; in rows it is whole rows, and
// where a tile is narrower than a row, at most kMaxPieces rows (one bulk
// copy a row); in planes it spans at most kMaxPieces runs of H·W: `elems`
// values where H·W is at least elems / (kMaxPieces - 1), else kMaxPieces - 1
// whole runs
struct Stages {
  long long base, step, end_, first, stride;

  __device__ __forceinline__ long long begin(long long q) const {
    return base + q * step;
  }
  __device__ __forceinline__ long long end(long long q) const {
    return min(end_, begin(q) + step);
  }
  __device__ __forceinline__ bool has(long long q) const {
    return begin(q) < end_;
  }
};

__device__ __forceinline__ Stages stages_of(const Geo& g, bool rows, int ct,
                                            long long u0, long long u1,
                                            long long len, int elems) {
  Stages st;
  if (rows) {
    st.step = elems / ct;
    if (ct != g.nc) st.step = min(st.step, (long long)kMaxPieces);
    st.base = u0;
    st.end_ = u1;
    st.first = 0;
    st.stride = 1;
  } else {
    st.step = g.inner * (kMaxPieces - 1) >= elems
                  ? elems
                  : (kMaxPieces - 1) * g.inner;
    st.base = 0;
    st.end_ = len;
    st.first = blockIdx.x;
    st.stride = gridDim.x;
  }
  return st;
}

// f(element offset in the tensor, element offset in the stage, elements)
// for each run of bytes of stage [u, e) of tile c0..c0+ct (rows) or of
// channel c0 (planes)
template <typename F>
__device__ __forceinline__ void pieces(const Geo& g, bool rows, int c0,
                                       int ct, long long u, long long e,
                                       F f) {
  if (rows) {
    if (ct == g.nc) {
      f(u * g.nc, 0LL, (e - u) * g.nc);
    } else {
      for (long long r = u; r < e; ++r) f(r * g.nc + c0, (r - u) * ct, ct);
    }
  } else {
    long long at = 0;
    while (u < e) {
      long long o = u / g.inner, off = u - o * g.inner;
      long long n = min(g.inner - off, e - u);
      f((o * g.nc + c0) * g.inner + off, at, n);
      at += n;
      u += n;
    }
  }
}

// The ring of stages of a block: `kTensors` tensors a stage, one mbarrier
// a stage, and `used`, the stages the block has consumed (its parity)
template <typename T, int kTensors>
struct Ring {
  static constexpr int kElems = kStageBytes / kTensors / (int)sizeof(T);
  T* buf;
  uint64_t* full;
  unsigned used;
  unsigned issued;  // thread 0's count of stages issued

  __device__ __forceinline__ T* at(unsigned n, int tensor) const {
    return buf + ((n % kStages) * kTensors + tensor) * kElems;
  }

  // thread 0: the loads of stage [u, e) into the next slot
  __device__ __forceinline__ void issue(const Geo& g, bool rows, int c0,
                                        int ct, long long u, long long e,
                                        const T* const* src) {
    uint64_t* bar = full + issued % kStages;
    long long width = rows ? ct : 1;
    mbar_expect(bar, (unsigned)((e - u) * width * sizeof(T) * kTensors));
#pragma unroll
    for (int i = 0; i < kTensors; ++i) {
      T* dst = at(issued, i);
      const T* s = src[i];
      pieces(g, rows, c0, ct, u, e,
             [&](long long go, long long so, long long n) {
               bulk_load(dst + so, s + go, (unsigned)(n * sizeof(T)), bar);
             });
    }
    ++issued;
  }

  __device__ __forceinline__ void wait() const {
    mbar_wait(full + used % kStages, (used / kStages) & 1u);
  }
};

// f(offset) for each V-vector (V values, one access) of channel c in [u,
// u1) of its N*H*W (planes; u, u1 and H*W multiples of V)
template <int V, typename F>
__device__ __forceinline__ void planes_each(const Geo& g, long long u,
                                            long long u1, int c, F f) {
  while (u < u1) {
    long long o = u / g.inner;
    long long end = min(u1, (o + 1) * g.inner);
    long long base = (o * g.nc + c) * g.inner + (u - o * g.inner);
    int count = (int)((end - u) / V);
#pragma unroll 4
    for (int q = threadIdx.x; q < count; q += blockDim.x)
      f(base + (long long)q * V);
    u = end;
  }
}

// bn_grad_apply's first design: f(offset) for each V-vector of slice s of
// channel c (planes), or each of this thread's rows of slice s (rows)
template <int V, typename F>
__device__ __forceinline__ void planes_slice(const Geo& g, int s, int c,
                                             F f) {
  long long m = g.outer * g.inner;
  long long j = (long long)s * g.span;
  long long j1 = min(m, j + g.span);
  while (j < j1) {
    long long o = j / g.inner;
    long long end = min(j1, (o + 1) * g.inner);
    long long base = (o * g.nc + c) * g.inner + (j - o * g.inner);
    int count = (int)((end - j) / V);
#pragma unroll 4
    for (int q = threadIdx.x; q < count; q += blockDim.x)
      f(base + (long long)q * V);
    j = end;
  }
}

template <typename F>
__device__ __forceinline__ void rows_slice(const Geo& g, int s, int ty, int ry,
                                           F f) {
  long long r0 = (long long)s * g.span;
  long long r1 = min(g.outer, r0 + g.span);
#pragma unroll 4
  for (long long r = r0 + ty; r < r1; r += ry) f(r * g.nc);
}

// a and b summed over the block in a fixed order; the sums in thread 0
__device__ __forceinline__ void block_sum2(double& a, double& b) {
  __shared__ double wa[kWarps], wb[kWarps];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wa[warp] = a;
    wb[warp] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    a = wa[0];
    b = wb[0];
    for (int w = 1; w < kWarps; ++w) {
      a += wa[w];
      b += wb[w];
    }
  }
  __syncthreads();
}

// True in the last of `arrivals` blocks to arrive at `ticket`, after every
// block's partials are visible to it
__device__ __forceinline__ bool last_arrival(unsigned* ticket, int arrivals) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == (unsigned)(arrivals - 1);
  __syncthreads();
  return last;
}

// sa += p[q·stride] and sb += p[off + q·stride] for q = first, first +
// step, … < n, in that order; kMlp loads in flight at a time (the
// partials sit in L2, so one dependent load after another would pay its
// latency each time)
__device__ __forceinline__ void run_sum(const double* p, long long off,
                                        long long stride, int first,
                                        int step, int n, double& sa,
                                        double& sb) {
  constexpr int kMlp = 8;
  for (int q0 = first; q0 < n; q0 += kMlp * step) {
    double va[kMlp], vb[kMlp];
#pragma unroll
    for (int u = 0; u < kMlp; ++u) {
      int q = q0 + u * step;
      va[u] = q < n ? __ldcg(p + q * stride) : 0.0;
      vb[u] = q < n ? __ldcg(p + off + q * stride) : 0.0;
    }
#pragma unroll
    for (int u = 0; u < kMlp; ++u) {
      if (q0 + u * step < n) {
        sa += va[u];
        sb += vb[u];
      }
    }
  }
}

// a channel's two sums written out, with what derives from them
template <bool kGrad, typename A>
__device__ __forceinline__ void finish(int c, double a, double b,
                                       const Geo& g, double* out,
                                       const A* invstd, A* dw, A* db) {
  out[c] = a;
  out[g.nc + c] = b;
  if constexpr (kGrad) {
    db[c] = (A)a;
    if (dw != nullptr) dw[c] = (A)(b * (double)invstd[c]);
  } else {
    if (c == 0) out[2 * g.nc] = (double)(g.outer * g.inner);
  }
}

// acc + p * q rounded as the plain version rounds it, p * q first.  For
// values widened from float32 (float32, bfloat16 and float16 inputs) the
// product of two 24-bit significands has at most 48 bits and is exact in
// float64 (their exponents keep it a normal number), so one fused
// multiply-add rounds once where the plain version's product did not
// round at all: bit for bit the same sum, one operation fewer.  float64
// inputs keep the product's rounding.
template <typename T>
__device__ __forceinline__ double mul_add(double p, double q, double acc) {
  if constexpr (sizeof(T) == 8) {
    double pq = p * q;
    return acc + pq;
  } else {
    return __fma_rn(p, q, acc);
  }
}

// Forward: s1 += x, s2 += x*x.  Backward: g1 += dy, g2 += dy * (x - mean).
// kPerValue: value k of the N goes to a[k], b[k] (rows: k is a channel),
// else to a[0], b[0] (planes: one channel)
template <typename T, int N, bool kGrad, bool kPerValue, typename A>
__device__ __forceinline__ void accumulate(const T* x, const T* dy,
                                           long long off, const A* mu,
                                           double* a, double* b) {
  A xv[N];
  load<T, N>(x + off, xv);
  if constexpr (kGrad) {
    A dv[N];
    load<T, N>(dy + off, dv);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      A d = xv[k] - mu[kPerValue ? k : 0];
      double gd = (double)dv[k];
      a[kPerValue ? k : 0] += gd;
      b[kPerValue ? k : 0] = mul_add<T>(gd, (double)d, b[kPerValue ? k : 0]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      double d = (double)xv[k];
      a[kPerValue ? k : 0] += d;
      b[kPerValue ? k : 0] = mul_add<T>(d, d, b[kPerValue ? k : 0]);
    }
  }
}

// The two per-channel sums of bn_stats (kGrad false) or bn_grad_stats.
// kRing: the stages through the shared-memory ring; else V values a load
// straight from device memory (V = 1: one value at a time)
template <typename T, int V, bool kRows, bool kGrad, bool kRing>
__device__ __forceinline__ void reduce(
    const T* __restrict__ x, const T* __restrict__ dy, const Geo& g,
    const typename AccOf<T>::type* __restrict__ mean,
    const typename AccOf<T>::type* __restrict__ invstd, double* partials,
    unsigned* tickets, double* out, typename AccOf<T>::type* dw,
    typename AccOf<T>::type* db) {
  using A = typename AccOf<T>::type;
  constexpr bool kBulk = kRing;
  // channels a thread sums (rows): two from the ring, a load's V without
  constexpr int P = kRows ? (kBulk ? pairs(sizeof(T)) : V) : 1;
  constexpr int kTensors = kGrad ? 2 : 1;
  constexpr int kRed = kThreads * (P > 2 ? P : 2);
  using R = Ring<T, kTensors>;
  __shared__ __align__(128) unsigned char ring[kBulk ? kStages * kStageBytes
                                                   : 16];
  __shared__ uint64_t full[kStages];
  // rows: the row groups' sums, then the block's in row 0; planes: [.][0]
  __shared__ double red[2][kRed];
  __shared__ bool arrived_last;  // the first block's: its cluster is last
  if (kAblateAll) return;
  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  const int cs = kAblateCluster ? 1 : g.cluster;
  const int K = gridDim.x / cs;  // clusters along a tile
  const int rank = s % cs, k = s / cs;
  const int tiles = kRows ? (g.nc + g.tw - 1) / g.tw : g.nc;
  const long long len = kRows ? g.outer : g.outer * g.inner;
  const long long u0 = min(len, (long long)s * g.span);
  const long long u1 = min(len, u0 + g.span);
  R q{reinterpret_cast<T*>(ring), full, 0u, 0u};
  if constexpr (kBulk) {
    if (tid == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(full + i);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    __syncthreads();  // the ring's barriers, and red free from the last tile
    const int c0 = kRows ? t * g.tw : t;
    const int ct = kRows ? min(g.tw, g.nc - c0) : 1;
    // rows: thread (gy, p) sums channels c0 + p·P … of rows gy, gy + ry, …
    const int tpr = kRows ? ct / P : 1;
    const int ry = kThreads / tpr;
    const int gy = tid / tpr, p = tid % tpr;
    const bool on = !kRows || gy < ry;
    double a[P], b[P];
    A mu[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      a[i] = 0.0;
      b[i] = 0.0;
      mu[i] = (kGrad && on) ? mean[c0 + (kRows ? p * P + i : 0)] : A(0);
    }
    if constexpr (kBulk) {
      const Stages st = stages_of(g, kRows, ct, u0, u1, len, R::kElems);
      const T* src[kTensors];
      src[0] = x;
      if constexpr (kGrad) src[kTensors - 1] = dy;
      long long pq = st.first;  // thread 0's next stage to issue
      if (tid == 0) {
        q.issued = q.used;
        for (int i = 0; i < kStages && st.has(pq); ++i, pq += st.stride)
          q.issue(g, kRows, c0, ct, st.begin(pq), st.end(pq), src);
      }
      for (long long cq = st.first; st.has(cq); cq += st.stride) {
        const long long u = st.begin(cq), e = st.end(cq);
        q.wait();
        const T* xs = q.at(q.used, 0);
        const T* ds = q.at(q.used, kTensors - 1);
        if constexpr (kRows) {
          const int n = (int)(e - u);
          if (on) {
#pragma unroll 4
            for (int r = gy; r < n; r += ry)
              accumulate<T, P, kGrad, true>(xs, ds, r * ct + p * P, mu, a, b);
          }
        } else {
          const int n = (int)(e - u) / V;
#pragma unroll 4
          for (int i = tid; i < n; i += kThreads)
            accumulate<T, V, kGrad, false>(xs, ds, (long long)i * V, mu, a,
                                           b);
        }
        __syncthreads();  // the slot read by every thread: refill it
        if (tid == 0 && st.has(pq)) {
          q.issue(g, kRows, c0, ct, st.begin(pq), st.end(pq), src);
          pq += st.stride;
        }
        ++q.used;
      }
    } else if constexpr (kRows) {
      if (on) {
#pragma unroll 4
        for (long long r = u0 + gy; r < u1; r += ry)
          accumulate<T, P, kGrad, true>(x, dy, r * g.nc + c0 + p * P, mu, a,
                                        b);
      }
    } else {
      // two vectors a step, into two pairs of sums: two dependent chains
      // of float64 additions a thread, not one
      double a1[1] = {0.0}, b1[1] = {0.0};
      for (long long u = u0; u < u1;) {
        const long long o = u / g.inner;
        const long long end = min(u1, (o + 1) * g.inner);
        const long long base = (o * g.nc + c0) * g.inner + (u - o * g.inner);
        const int count = (int)((end - u) / V);
        int q = tid;
#pragma unroll 2
        for (; q + kThreads < count; q += 2 * kThreads) {
          accumulate<T, V, kGrad, false>(x, dy, base + (long long)q * V, mu,
                                         a, b);
          accumulate<T, V, kGrad, false>(
              x, dy, base + (long long)(q + kThreads) * V, mu, a1, b1);
        }
        if (q < count)
          accumulate<T, V, kGrad, false>(x, dy, base + (long long)q * V, mu,
                                         a, b);
        u = end;
      }
      a[0] += a1[0];
      b[0] += b1[0];
    }
    // the block's sums, in red[.][c] for its ct channels
    if constexpr (kRows) {
      if (on) {
#pragma unroll
        for (int i = 0; i < P; ++i) {
          red[0][gy * ct + p * P + i] = a[i];
          red[1][gy * ct + p * P + i] = b[i];
        }
      }
      __syncthreads();
      for (int c = tid; c < ct; c += kThreads) {
        double sa = red[0][c], sb = red[1][c];
        for (int y = 1; y < ry; ++y) {
          sa += red[0][y * ct + c];
          sb += red[1][y * ct + c];
        }
        red[0][c] = sa;
        red[1][c] = sb;
      }
    } else {
      block_sum2(a[0], b[0]);
      if (tid == 0) {
        red[0][0] = a[0];
        red[1][0] = b[0];
      }
    }
    // the cluster's sums, in rank order, in its first block
    cg::cluster_group cluster = cg::this_cluster();
    if (cs > 1) {
      cluster.sync();
      if (rank == 0) {
        for (int c = tid; c < ct; c += kThreads) {
          double sa = red[0][c], sb = red[1][c];
          for (int r = 1; r < cs; ++r) {
            const double* o = cluster.map_shared_rank(&red[0][0], r);
            sa += o[c];
            sb += o[kRed + c];
          }
          red[0][c] = sa;
          red[1][c] = sb;
        }
      }
    }
    if (K == 1 || kAblateOneLevel) {
      if (cs > 1) cluster.sync();  // no block leaves while the first reads it
      if (rank == 0) {
        for (int c = tid; c < ct; c += kThreads)
          finish<kGrad>(c0 + c, red[0][c], red[1][c], g, out, invstd, dw, db);
      }
      continue;
    }
    // the clusters' partials cluster-major, (k, c) at k·C + c, so that the
    // last cluster's loads of one cluster's channels coalesce
    if (rank == 0) {
      for (int c = tid; c < ct; c += kThreads) {
        partials[(long long)k * g.nc + c0 + c] = red[0][c];
        partials[((long long)K + k) * g.nc + c0 + c] = red[1][c];
      }
      const bool arrived = last_arrival(tickets + t, K);
      if (tid == 0) {
        // told to every block of the cluster, in its own shared memory: a
        // block reads no other after the sync, whose first may have left
        for (int r = 0; r < cs; ++r)
          *(cs > 1 ? cluster.map_shared_rank(&arrived_last, r)
                   : &arrived_last) = arrived;
        if (arrived) tickets[t] = 0u;
      }
    }
    if (cs > 1)
      cluster.sync();  // the ticket's answer, and no block leaves early
    else
      __syncthreads();
    if (!arrived_last) continue;
    __threadfence();
    // the last cluster: block `rank` sums channels lo…hi of the tile, each
    // channel's partials in `parts` interleaved runs, each in cluster
    // order, then the runs in order
    const int per = (ct + cs - 1) / cs;
    const int lo = min(ct, rank * per), cc = min(ct, lo + per) - lo;
    if (cc == 0) continue;
    const int parts = max(1, min(kThreads / cc, K));
    for (int i = tid; i < parts * cc; i += kThreads) {
      double sa = 0.0, sb = 0.0;
      run_sum(partials + c0 + lo + i % cc, (long long)K * g.nc, g.nc,
              i / cc, parts, K, sa, sb);
      red[0][i] = sa;
      red[1][i] = sb;
    }
    __syncthreads();
    for (int c = tid; c < cc; c += kThreads) {
      double sa = 0.0, sb = 0.0;
      for (int j = 0; j < parts; ++j) {
        sa += red[0][j * cc + c];
        sb += red[1][j * cc + c];
      }
      finish<kGrad>(c0 + lo + c, sa, sb, g, out, invstd, dw, db);
    }
  }
}

template <typename T, int V, bool kRows, bool kRing>
__global__ void __launch_bounds__(kThreads, min_blocks(kRows, kRing))
    bn_stats_kernel(const T* __restrict__ x, Geo g, double* partials,
                    unsigned* tickets, double* out) {
  reduce<T, V, kRows, false, kRing>(x, nullptr, g, nullptr, nullptr,
                                    partials, tickets, out, nullptr, nullptr);
}

template <typename T, int V, bool kRows, bool kRing>
__global__ void __launch_bounds__(kThreads, min_blocks(kRows, kRing))
    bn_grad_stats_kernel(
    const T* __restrict__ dy, const T* __restrict__ x, Geo g,
    const typename AccOf<T>::type* __restrict__ mean,
    const typename AccOf<T>::type* __restrict__ invstd, double* partials,
    unsigned* tickets, double* out, typename AccOf<T>::type* dw,
    typename AccOf<T>::type* db) {
  reduce<T, V, kRows, true, kRing>(x, dy, g, mean, invstd, partials, tickets,
                                   out, dw, db);
}

// A channel's forward coefficients from its sums
template <typename A>
struct Fwd {
  A mean, var, invstd, scale, bias;
};

template <typename A>
__device__ __forceinline__ Fwd<A> forward_coef(const double* sums, int nc,
                                               int c, double eps, const A* w,
                                               const A* b) {
  double n = sums[2 * nc];
  double m = sums[c] / n;
  double v = sums[nc + c] / n - m * m;
  v = v < 0.0 ? 0.0 : v;  // a NaN stays NaN
  Fwd<A> k;
  k.mean = (A)m;
  k.var = (A)v;
  A ve = k.var + (A)eps;
  k.invstd = (A)(1.0 / sqrt((double)ve));
  k.scale = w != nullptr ? k.invstd * w[c] : k.invstd;
  k.bias = b[c];
  return k;
}

template <typename A>
__device__ __forceinline__ void write_stats(int c, const Fwd<A>& k,
                                            const A* rm, const A* rv,
                                            double momentum, A* mean_out,
                                            A* invstd_out, A* rm_out,
                                            A* rv_out) {
  A m = (A)momentum, om = (A)(1.0 - momentum);
  mean_out[c] = k.mean;
  invstd_out[c] = k.invstd;
  rm_out[c] = rm[c] * m + k.mean * om;
  rv_out[c] = rv[c] * m + k.var * om;
}

template <typename A>
__device__ __forceinline__ A normalise(A v, A mean, A scale, A bias) {
  A t = v - mean;
  t = t * scale;
  return t + bias;
}

template <typename T, int V, bool kRows, bool kRing>
__global__ void __launch_bounds__(kThreads, min_blocks(kRows, kRing))
    bn_apply_kernel(
    const T* __restrict__ x, T* __restrict__ y, Geo g,
    const double* __restrict__ sums,
    const typename AccOf<T>::type* __restrict__ w,
    const typename AccOf<T>::type* __restrict__ b,
    const typename AccOf<T>::type* __restrict__ rm,
    const typename AccOf<T>::type* __restrict__ rv, double momentum,
    double eps, typename AccOf<T>::type* mean_out,
    typename AccOf<T>::type* invstd_out, typename AccOf<T>::type* rm_out,
    typename AccOf<T>::type* rv_out) {
  using A = typename AccOf<T>::type;
  constexpr bool kBulk = kRing;
  using R = Ring<T, 1>;
  __shared__ __align__(128) unsigned char ring[kBulk ? kStages * kStageBytes
                                                   : 16];
  __shared__ uint64_t full[kStages];
  // the tile's coefficients: mean, scale, bias of each channel
  __shared__ A coef[3][2 * kThreads];
  const int tid = threadIdx.x;
  const int s = blockIdx.x;
  const int tiles = kRows ? (g.nc + g.tw - 1) / g.tw : g.nc;
  const long long len = kRows ? g.outer : g.outer * g.inner;
  const long long u0 = min(len, (long long)s * g.span);
  const long long u1 = min(len, u0 + g.span);
  R q{reinterpret_cast<T*>(ring), full, 0u, 0u};
  if constexpr (kBulk) {
    if (tid == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(full + i);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
  }
  for (int t = blockIdx.y; t < tiles; t += gridDim.y) {
    __syncthreads();  // the barriers, and coef free from the last tile
    const int c0 = kRows ? t * g.tw : t;
    const int ct = kRows ? min(g.tw, g.nc - c0) : 1;
    const T* const src[1] = {x};  // one tensor a stage
    const Stages st = stages_of(g, kRows, ct, u0, u1, len, R::kElems);
    long long pq = st.first;  // thread 0's next stage to issue
    if constexpr (kBulk) {
      if (tid == 0) {
        q.issued = q.used;
        for (int i = 0; i < kStages && st.has(pq); ++i, pq += st.stride)
          q.issue(g, kRows, c0, ct, st.begin(pq), st.end(pq), src);
      }
    }
    // each channel's coefficients once, while the first stages load; a
    // thread's two channels (tiles above 256) in one dependent chain's time
    for (int c = tid; c < ct; c += 2 * kThreads) {
      const int cc[2] = {c, min(c + kThreads, ct - 1)};
      Fwd<A> k[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        k[i] = forward_coef<A>(sums, g.nc, c0 + cc[i], eps, w, b);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 1 && c + kThreads >= ct) break;
        coef[0][cc[i]] = k[i].mean;
        coef[1][cc[i]] = k[i].scale;
        coef[2][cc[i]] = k[i].bias;
        if (s == 0)
          write_stats(c0 + cc[i], k[i], rm, rv, momentum, mean_out,
                      invstd_out, rm_out, rv_out);
      }
    }
    __syncthreads();
    // rows: thread (gy, col) normalises channels c0 + col·N … of rows gy,
    // gy + ry, …, N = V values (one 16-byte access) or one
    constexpr int N = kRows ? V : 1;
    const int tpr = kRows ? ct / N : 1;
    const int ry = kThreads / tpr;
    const int gy = tid / tpr, col = tid % tpr;
    const bool on = !kRows || gy < ry;
    A km[N], ks[N], kb[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = kRows ? col * N + i : 0;
      km[i] = on ? coef[0][c] : A(0);
      ks[i] = on ? coef[1][c] : A(0);
      kb[i] = on ? coef[2][c] : A(0);
    }
    if constexpr (kBulk) {
      for (long long cq = st.first; st.has(cq); cq += st.stride) {
        const long long u = st.begin(cq), e = st.end(cq);
        q.wait();
        const T* xs = q.at(q.used, 0);
        if constexpr (kRows) {
          const int n = (int)(e - u);
          if (on) {
#pragma unroll 4
            for (int r = gy; r < n; r += ry) {
              A v[V];
              load<T, V>(xs + r * ct + col * V, v);
#pragma unroll
              for (int i = 0; i < V; ++i)
                v[i] = normalise(v[i], km[i], ks[i], kb[i]);
              store<T, V>(y + (u + r) * g.nc + c0 + col * V, v);
            }
          }
        } else {
          // the stage's values from the start of plane o0 on
          const int n = (int)(e - u) / V;
          const long long o0 = u / g.inner, j0 = u - o0 * g.inner;
#pragma unroll 4
          for (int i = tid; i < n; i += kThreads) {
            long long j = j0 + (long long)i * V, o = o0;
            while (j >= g.inner) {
              j -= g.inner;
              ++o;
            }
            A v[V];
            load<T, V>(xs + i * V, v);
#pragma unroll
            for (int k = 0; k < V; ++k)
              v[k] = normalise(v[k], km[0], ks[0], kb[0]);
            store<T, V>(y + (o * g.nc + c0) * g.inner + j, v);
          }
        }
        __syncthreads();  // the slot read by every thread: refill it
        if (tid == 0 && st.has(pq)) {
          q.issue(g, kRows, c0, ct, st.begin(pq), st.end(pq), src);
          pq += st.stride;
        }
        ++q.used;
      }
    } else if constexpr (kRows) {
      if (on) {
#pragma unroll 4
        for (long long r = u0 + gy; r < u1; r += ry) {
          const long long off = r * g.nc + c0 + col * V;
          A v[V];
          load<T, V>(x + off, v);
#pragma unroll
          for (int i = 0; i < V; ++i)
            v[i] = normalise(v[i], km[i], ks[i], kb[i]);
          store<T, V>(y + off, v);
        }
      }
    } else {
      planes_each<V>(g, u0, u1, c0, [&](long long off) {
        A v[V];
        load<T, V>(x + off, v);
#pragma unroll
        for (int i = 0; i < V; ++i)
          v[i] = normalise(v[i], km[0], ks[0], kb[0]);
        store<T, V>(y + off, v);
      });
    }
  }
}

// A channel's backward coefficients from the (reduced) sums
template <typename A>
struct Bwd {
  A mean, c1, c2, scale;
};

template <typename A>
__device__ __forceinline__ Bwd<A> backward_coef(const double* gs,
                                                const double* sums, int nc,
                                                int c, const A* mean,
                                                const A* invstd, const A* w) {
  double n = sums[2 * nc];
  A is = invstd[c];
  double isd = (double)is;
  Bwd<A> k;
  k.mean = mean[c];
  k.c1 = (A)(gs[c] / n);
  k.c2 = (A)((gs[nc + c] / n) * (isd * isd));
  k.scale = w != nullptr ? is * w[c] : is;
  return k;
}

template <typename A>
__device__ __forceinline__ A input_grad(A dv, A xv, const Bwd<A>& k) {
  A d = xv - k.mean;
  A t = dv - k.c1;
  t = t - d * k.c2;
  return k.scale * t;
}

template <typename T, int V, bool kRows>
__global__ void __launch_bounds__(kThreads) bn_grad_apply_kernel(
    const T* __restrict__ dy, const T* __restrict__ x, T* __restrict__ dx,
    Geo g, const double* __restrict__ gs, const double* __restrict__ sums,
    const typename AccOf<T>::type* __restrict__ mean,
    const typename AccOf<T>::type* __restrict__ invstd,
    const typename AccOf<T>::type* __restrict__ w) {
  using A = typename AccOf<T>::type;
  const int s = blockIdx.x;
  if constexpr (!kRows) {
    const int c = blockIdx.y;
    const Bwd<A> k = backward_coef<A>(gs, sums, g.nc, c, mean, invstd, w);
    planes_slice<V>(g, s, c, [&](long long off) {
      A dv[V], xv[V];
      load<T, V>(dy + off, dv);
      load<T, V>(x + off, xv);
#pragma unroll
      for (int q = 0; q < V; ++q) dv[q] = input_grad(dv[q], xv[q], k);
      store<T, V>(dx + off, dv);
    });
  } else {
    const int tw = g.tw, ry = blockDim.x / tw;
    const int tx = threadIdx.x % tw, ty = threadIdx.x / tw;
    const int col = blockIdx.y * tw + tx;
    if (col >= g.nc / V) return;
    Bwd<A> k[V];
#pragma unroll
    for (int q = 0; q < V; ++q)
      k[q] = backward_coef<A>(gs, sums, g.nc, col * V + q, mean, invstd, w);
    rows_slice(g, s, ty, ry, [&](long long roff) {
      A dv[V], xv[V];
      load<T, V>(dy + roff + col * V, dv);
      load<T, V>(x + roff + col * V, xv);
#pragma unroll
      for (int q = 0; q < V; ++q) dv[q] = input_grad(dv[q], xv[q], k[q]);
      store<T, V>(dx + roff + col * V, dv);
    });
  }
}

// The launch shape of a geometry; false where an argument is out of range.
// bn_stats, bn_apply and bn_grad_stats (`first` false): grid (slices,
// items), clusters of `cluster` along x, tiles of at most 512 channels, a
// multiple of the vector, that 256 threads cover (two channels a thread
// through the ring, a vector's without); bn_grad_apply (`first`): its first
// design's grid (slices, tiles or channels), g.tw then vector columns
bool shape_of(Geo& g, bool rows, int width, int mode, bool first,
              dim3& grid, dim3& block) {
  const bool vec = mode != 0;
  const int v = vec ? 16 / width : 1;
  if (g.slices < 1 || g.nc < 1 || g.span < 1) return false;
  block = dim3(kThreads);
  if (first) {
    if (rows) {
      if (g.tw % v != 0) return false;
      g.tw /= v;
      int ncol = g.nc / v;
      if (g.tw < 1 || g.tw > 32 || ncol * v != g.nc) return false;
      int tiles = (ncol + g.tw - 1) / g.tw;
      if (tiles > 65535) return false;
      grid = dim3(g.slices, tiles);
      block = dim3(g.tw * (kThreads / g.tw));
    } else {
      if (g.nc > 65535 || g.inner % v != 0 || g.span % v != 0 ||
          g.span / v > 0x7fffffffLL)
        return false;
      grid = dim3(g.slices, g.nc);
    }
    return true;
  }
  if (g.cluster < 1 || g.cluster > kMaxCluster || g.slices % g.cluster != 0 ||
      g.items < 1 || g.items > 65535)
    return false;
  if (rows) {
    const int per = mode == 1 ? pairs(width) : v;
    if (g.tw < 1 || g.tw > 2 * kThreads || g.tw > kThreads * per ||
        g.tw % v != 0 || g.nc % v != 0 || g.inner != 1)
      return false;
  } else {
    if (g.inner % v != 0 || g.span % v != 0) return false;
  }
  grid = dim3(g.slices, g.items);
  return true;
}

Geo geo_of(long long outer, long long inner, long long span, int nc,
           int slices, int tw, int cluster, int items) {
  Geo g;
  g.outer = outer;
  g.inner = inner;
  g.span = span;
  g.nc = nc;
  g.slices = slices;
  g.tw = tw;
  g.cluster = cluster;
  g.items = items;
  return g;
}

// a launch of `kernel` with clusters of `cluster` blocks along x
template <typename... Exp, typename... Act>
cudaError_t launch(void (*kernel)(Exp...), dim3 grid, int cluster,
                   cudaStream_t st, Act... args) {
  if (cluster == 1) {
    kernel<<<grid, kThreads, 0, st>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// L::run<T, V, kRows, kRing>(args...) for the dtype code (0 float32, 1
// bfloat16, 2 float64, 3 float16), the mode (0 one value at a time, 1
// 16-byte vectors through the ring, 2 16-byte loads without it) and rows;
// false for another code
template <typename L, typename T, bool kRows, typename... Args>
void modes(int mode, Args... args) {
  constexpr int kV = 16 / sizeof(T);
  if (mode == 1)
    L::template run<T, kV, kRows, true>(args...);
  else if (mode == 2)
    L::template run<T, kV, kRows, false>(args...);
  else
    L::template run<T, 1, kRows, false>(args...);
}

template <typename L, typename T, typename... Args>
void variants(int mode, bool rows, Args... args) {
  if (rows)
    modes<L, T, true>(mode, args...);
  else
    modes<L, T, false>(mode, args...);
}

template <typename L, typename... Args>
bool dispatch(int dtype, int mode, bool rows, Args... args) {
  switch (dtype) {
    case 0:
      variants<L, float>(mode, rows, args...);
      return true;
    case 1:
      variants<L, __nv_bfloat16>(mode, rows, args...);
      return true;
    case 2:
      variants<L, double>(mode, rows, args...);
      return true;
    case 3:
      variants<L, __half>(mode, rows, args...);
      return true;
    default:
      return false;
  }
}

struct StatsLaunch {
  template <typename T, int V, bool R, bool kRing>
  static void run(cudaError_t* err, dim3 grid, int cluster, cudaStream_t st,
                  const void* x, Geo g, double* partials, unsigned* tickets,
                  double* out) {
    *err = launch(bn_stats_kernel<T, V, R, kRing>, grid, cluster, st,
                  static_cast<const T*>(x), g, partials, tickets, out);
  }
};

struct ApplyLaunch {
  template <typename T, int V, bool R, bool kRing>
  static void run(cudaError_t* err, dim3 grid, int cluster, cudaStream_t st,
                  const void* x, void* y, Geo g, const double* sums,
                  const void* w, const void* b, const void* rm,
                  const void* rv, double momentum, double eps, void* mean_out,
                  void* invstd_out, void* rm_out, void* rv_out) {
    using A = typename AccOf<T>::type;
    *err = launch(bn_apply_kernel<T, V, R, kRing>, grid, cluster, st,
                  static_cast<const T*>(x), static_cast<T*>(y), g, sums,
                  static_cast<const A*>(w), static_cast<const A*>(b),
                  static_cast<const A*>(rm), static_cast<const A*>(rv),
                  momentum, eps, static_cast<A*>(mean_out),
                  static_cast<A*>(invstd_out), static_cast<A*>(rm_out),
                  static_cast<A*>(rv_out));
  }
};

struct GradStatsLaunch {
  template <typename T, int V, bool R, bool kRing>
  static void run(cudaError_t* err, dim3 grid, int cluster, cudaStream_t st,
                  const void* dy, const void* x, Geo g, const void* mean,
                  const void* invstd, double* partials, unsigned* tickets,
                  double* out, void* dw, void* db) {
    using A = typename AccOf<T>::type;
    *err = launch(bn_grad_stats_kernel<T, V, R, kRing>, grid, cluster, st,
                  static_cast<const T*>(dy), static_cast<const T*>(x), g,
                  static_cast<const A*>(mean), static_cast<const A*>(invstd),
                  partials, tickets, out, static_cast<A*>(dw),
                  static_cast<A*>(db));
  }
};

struct GradApplyLaunch {
  template <typename T, int V, bool R, bool kRing>
  static void run(cudaError_t* err, dim3 grid, dim3 block, cudaStream_t st,
                  const void* dy, const void* x, void* dx, Geo g,
                  const double* gs, const double* sums, const void* mean,
                  const void* invstd, const void* w) {
    using A = typename AccOf<T>::type;
    bn_grad_apply_kernel<T, V, R><<<grid, block, 0, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x),
        static_cast<T*>(dx), g, gs, sums, static_cast<const A*>(mean),
        static_cast<const A*>(invstd), static_cast<const A*>(w));
    *err = cudaGetLastError();
  }
};

// resident blocks a SM of a kernel at kThreads and, with clusters of
// `cluster` blocks, the clusters the card holds at once
template <typename... Exp>
cudaError_t occupancy_of(void (*kernel)(Exp...), int cluster, int* blocks,
                         int* clusters) {
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads,
                                                    0);
  *clusters = 0;
  if (e != cudaSuccess || cluster <= 1) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel, &cfg);
}

struct Occupancy {
  template <typename T, int V, bool R, bool kRing>
  static void run(cudaError_t* err, int kernel, int cluster, int* blocks,
                  int* clusters) {
    switch (kernel) {
      case 0:
        *err = occupancy_of(bn_stats_kernel<T, V, R, kRing>, cluster, blocks,
                            clusters);
        break;
      case 1:
        *err = occupancy_of(bn_apply_kernel<T, V, R, kRing>, cluster, blocks,
                            clusters);
        break;
      case 2:
        *err = occupancy_of(bn_grad_stats_kernel<T, V, R, kRing>, cluster, blocks,
                            clusters);
        break;
      case 3:
        *err = occupancy_of(bn_grad_apply_kernel<T, V, R>, cluster, blocks,
                            clusters);
        break;
      default:
        *err = cudaErrorInvalidValue;
    }
  }
};

int dtype_width(int dtype) {
  return dtype == 0 ? 4 : dtype == 1 || dtype == 3 ? 2 : dtype == 2 ? 8 : 0;
}

}  // namespace

// The geometry arguments of every entry point: rows (0 planes, 1 rows),
// outer, inner, span, channels, slices, tw, mode (0 one value at a time;
// 16-byte accesses, 1 through the ring of bulk copies, 2 straight from
// device memory; bn_grad_apply: vectors where not 0), cluster, items
// (models/batchnorm.py:_plan)
#define STP_BN_GEO                                                       \
  int rows, long long outer, long long inner, long long span, int nc,    \
      int slices, int tw, int mode, int cluster, int items

#define STP_BN_SHAPE(first)                                              \
  Geo g = geo_of(outer, inner, span, nc, slices, tw, cluster, items);    \
  int width = dtype_width(dtype);                                        \
  if (width == 0) return (int)cudaErrorInvalidValue;                     \
  dim3 grid, block;                                                      \
  if (mode < 0 || mode > 2 ||                                            \
      !shape_of(g, rows != 0, width, mode, first, grid, block))          \
    return (int)cudaErrorInvalidValue;                                   \
  cudaStream_t st = (cudaStream_t)stream;                                \
  cudaError_t err = cudaSuccess;

// Resident blocks a SM of one instantiation (kernel 0 bn_stats, 1
// bn_apply, 2 bn_grad_stats, 3 bn_grad_apply) and, for a cluster above
// 1, the clusters of that size the card holds at once
extern "C" int stp_bn_occupancy(int kernel, int dtype, int rows, int mode,
                                int cluster, int* blocks, int* clusters) {
  cudaError_t err = cudaSuccess;
  if (mode < 0 || mode > 2 ||
      !dispatch<Occupancy>(dtype, mode, rows != 0, &err, kernel,
                           cluster, blocks, clusters))
    return (int)cudaErrorInvalidValue;
  return (int)err;
}

extern "C" int stp_bn_stats(const void* x, int dtype, STP_BN_GEO,
                            double* partials, unsigned* tickets, double* out,
                            void* stream) {
  STP_BN_SHAPE(false)
  dispatch<StatsLaunch>(dtype, mode, rows != 0, &err, grid, g.cluster,
                        st, x, g, partials, tickets, out);
  return (int)err;
}

extern "C" int stp_bn_apply(const void* x, void* y, int dtype, STP_BN_GEO,
                            const double* sums, const void* w, const void* b,
                            const void* rm, const void* rv, double momentum,
                            double eps, void* mean_out, void* invstd_out,
                            void* rm_out, void* rv_out, void* stream) {
  STP_BN_SHAPE(false)
  dispatch<ApplyLaunch>(dtype, mode, rows != 0, &err, grid, 1, st, x, y,
                        g, sums, w, b, rm, rv, momentum, eps, mean_out,
                        invstd_out, rm_out, rv_out);
  return (int)err;
}

extern "C" int stp_bn_grad_stats(const void* dy, const void* x, int dtype,
                                 STP_BN_GEO, const void* mean,
                                 const void* invstd, double* partials,
                                 unsigned* tickets, double* out, void* dw,
                                 void* db, void* stream) {
  STP_BN_SHAPE(false)
  dispatch<GradStatsLaunch>(dtype, mode, rows != 0, &err, grid,
                            g.cluster, st, dy, x, g, mean, invstd, partials,
                            tickets, out, dw, db);
  return (int)err;
}

extern "C" int stp_bn_grad_apply(const void* dy, const void* x, void* dx,
                                 int dtype, STP_BN_GEO, const double* gs,
                                 const double* sums, const void* mean,
                                 const void* invstd, const void* w,
                                 void* stream) {
  STP_BN_SHAPE(true)
  dispatch<GradApplyLaunch>(dtype, mode, rows != 0, &err, grid, block,
                            st, dy, x, dx, g, gs, sums, mean, invstd, w);
  return (int)err;
}
