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
// as in the plain PyTorch versions beside the wrapper.
//
// Layouts.  "planes": a contiguous NCHW tensor, one block per (slice of
// a channel's N*H*W values, channel).  "rows": the tensor as an
// (N*H*W, C) row-major matrix (channels-last, the port's layout on the
// card, or H*W = 1), one block per (slice of rows, tile of channels),
// neighbouring threads on neighbouring channels.  Accesses are 16 bytes
// wide where the widths and the pointers allow (V values), else one value.
//
// Determinism.  Each sum is two levels in a fixed order: a block sums its
// slice (each thread in index order; then, in planes, its warps by
// shuffles and the warps' sums in order; in rows, its row groups in order)
// into a partial; the last block of a channel (planes) or tile (rows),
// found by an atomic ticket after a __threadfence, sums the partials in
// slice order (several loads in flight) and resets the ticket for the
// next launch.  The result
// depends on the shape, layout and alignment only, never on the blocks'
// schedule: it is bit-identical from launch to launch.  The tickets are
// one zeroed buffer per device that every launch leaves zeroed, so
// launches that share it must run in order (one stream).
//
// Bound on an H100: memory.  The forward reads x twice and writes y; the
// backward reads x and dy twice and writes dx.  The float64 sums cost two
// or three FP64 operations a value, a small part of the card's FP64 rate
// at the rate HBM delivers values.  The grids aim at four 256-thread
// blocks per SM, and each thread keeps its loads in flight with 16-byte
// accesses and an unrolled loop.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

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

// V consecutive values: one 16-byte access when V > 1
template <typename T, int V, typename A>
__device__ __forceinline__ void load(const T* p, A (&v)[V]) {
  if constexpr (V == 1) {
    v[0] = widen(p[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "one 16-byte access");
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = widen(e[k]);
  }
}

template <typename T, int V, typename A>
__device__ __forceinline__ void store(T* p, const A (&v)[V]) {
  if constexpr (V == 1) {
    narrow(v[0], p);
  } else {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < V; ++k) narrow(v[k], e + k);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

struct Geo {
  long long outer;  // planes: images N; rows: rows N*H*W
  long long inner;  // planes: H*W; rows: 1
  long long span;   // planes: a channel's values per slice; rows: rows
  int nc;           // channels
  int slices;       // blocks along a channel (grid x)
  int tw;           // rows: vector columns per tile (grid y: tiles)
};

// f(offset) for each of this block's V-vectors of channel c (planes)
template <int V, typename F>
__device__ __forceinline__ void planes_each(const Geo& g, int s, int c, F f) {
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

// f(row offset) for each of this thread's rows of slice s (rows)
template <typename F>
__device__ __forceinline__ void rows_each(const Geo& g, int s, int ty, int ry,
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

// True in the last of `slices` blocks to arrive at `ticket`, after every
// block's partials are visible to it
__device__ __forceinline__ bool last_arrival(unsigned* ticket, int slices) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(ticket, 1u) == (unsigned)(slices - 1);
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

// Forward: s1 += x, s2 += x*x.  Backward: g1 += dy, g2 += dy * (x - mean).
// kPerValue: value k of the vector goes to a[k], b[k] (rows: k is a
// channel), else to a[0], b[0] (planes: one channel)
template <typename T, int V, bool kGrad, bool kPerValue, typename A>
__device__ __forceinline__ void accumulate(const T* x, const T* dy,
                                           long long off, const A* mu,
                                           double* a, double* b) {
  A xv[V];
  load<T, V>(x + off, xv);
  if constexpr (kGrad) {
    A dv[V];
    load<T, V>(dy + off, dv);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      A d = xv[k] - mu[kPerValue ? k : 0];
      double gd = (double)dv[k];
      a[kPerValue ? k : 0] += gd;
      b[kPerValue ? k : 0] += gd * (double)d;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      double d = (double)xv[k];
      a[kPerValue ? k : 0] += d;
      b[kPerValue ? k : 0] += d * d;
    }
  }
}

// The two per-channel sums of bn_stats (kGrad false) or bn_grad_stats
template <typename T, int V, bool kRows, bool kGrad>
__device__ __forceinline__ void reduce(
    const T* __restrict__ x, const T* __restrict__ dy, Geo g,
    const typename AccOf<T>::type* __restrict__ mean,
    const typename AccOf<T>::type* __restrict__ invstd, double* partials,
    unsigned* tickets, double* out, typename AccOf<T>::type* dw,
    typename AccOf<T>::type* db) {
  using A = typename AccOf<T>::type;
  const long long S = g.slices;
  const int s = blockIdx.x;
  if constexpr (!kRows) {
    const int c = blockIdx.y;
    double a[1] = {0.0}, b[1] = {0.0};
    A mu[1] = {kGrad ? mean[c] : A(0)};
    planes_each<V>(g, s, c, [&](long long off) {
      accumulate<T, V, kGrad, false>(x, dy, off, mu, a, b);
    });
    block_sum2(a[0], b[0]);
    if (threadIdx.x == 0) {
      partials[(long long)c * S + s] = a[0];
      partials[((long long)g.nc + c) * S + s] = b[0];
    }
    if (!last_arrival(tickets + c, g.slices)) return;
    double sa = 0.0, sb = 0.0;
    run_sum(partials + (long long)c * S, (long long)g.nc * S, 1,
            threadIdx.x, blockDim.x, g.slices, sa, sb);
    block_sum2(sa, sb);
    if (threadIdx.x == 0) {
      finish<kGrad>(c, sa, sb, g, out, invstd, dw, db);
      tickets[c] = 0u;
    }
  } else {
    __shared__ double red[2][kThreads * V];
    const int tw = g.tw, ry = blockDim.x / tw;
    const int tx = threadIdx.x % tw, ty = threadIdx.x / tw;
    const int t = blockIdx.y;
    const int col = t * tw + tx;  // this thread's vector column
    const bool on = col < g.nc / V;
    double a[V], b[V];
    A mu[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a[k] = 0.0;
      b[k] = 0.0;
      mu[k] = (kGrad && on) ? mean[col * V + k] : A(0);
    }
    if (on)
      rows_each(g, s, ty, ry, [&](long long roff) {
        accumulate<T, V, kGrad, true>(x, dy, roff + col * V, mu, a, b);
      });
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[0][threadIdx.x * V + k] = a[k];
      red[1][threadIdx.x * V + k] = b[k];
    }
    __syncthreads();
    const int cw = tw * V;                 // channels per tile
    const int c0 = t * cw;
    const int ct = min(cw, g.nc - c0);     // channels in this tile
    // the partials slice-major here, (s, c) at s·C + c, so that the
    // last block's loads of one slice's channels coalesce
    if ((int)threadIdx.x < ct) {
      double sa = 0.0, sb = 0.0;
      for (int y = 0; y < ry; ++y) {
        sa += red[0][y * cw + threadIdx.x];
        sb += red[1][y * cw + threadIdx.x];
      }
      partials[(long long)s * g.nc + c0 + threadIdx.x] = sa;
      partials[(S + s) * g.nc + c0 + threadIdx.x] = sb;
    }
    if (!last_arrival(tickets + t, g.slices)) return;
    // the partials of each channel in `parts` interleaved runs, each in
    // slice order, then the runs in order
    const int parts = blockDim.x / cw;
    const int p = threadIdx.x % cw, part = threadIdx.x / cw;
    if (part < parts && p < ct) {
      double sa = 0.0, sb = 0.0;
      run_sum(partials + c0 + p, S * g.nc, g.nc, part, parts, g.slices,
              sa, sb);
      red[0][part * cw + p] = sa;
      red[1][part * cw + p] = sb;
    }
    __syncthreads();
    if ((int)threadIdx.x < ct) {
      double sa = 0.0, sb = 0.0;
      for (int q = 0; q < parts; ++q) {
        sa += red[0][q * cw + threadIdx.x];
        sb += red[1][q * cw + threadIdx.x];
      }
      finish<kGrad>(c0 + threadIdx.x, sa, sb, g, out, invstd, dw, db);
    }
    if (threadIdx.x == 0) tickets[t] = 0u;
  }
}

template <typename T, int V, bool kRows>
__global__ void __launch_bounds__(kThreads)
    bn_stats_kernel(const T* __restrict__ x, Geo g, double* partials,
                    unsigned* tickets, double* out) {
  reduce<T, V, kRows, false>(x, nullptr, g, nullptr, nullptr, partials,
                             tickets, out, nullptr, nullptr);
}

template <typename T, int V, bool kRows>
__global__ void __launch_bounds__(kThreads) bn_grad_stats_kernel(
    const T* __restrict__ dy, const T* __restrict__ x, Geo g,
    const typename AccOf<T>::type* __restrict__ mean,
    const typename AccOf<T>::type* __restrict__ invstd, double* partials,
    unsigned* tickets, double* out, typename AccOf<T>::type* dw,
    typename AccOf<T>::type* db) {
  reduce<T, V, kRows, true>(x, dy, g, mean, invstd, partials, tickets, out,
                            dw, db);
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
__device__ __forceinline__ A normalise(A v, const Fwd<A>& k) {
  A t = v - k.mean;
  t = t * k.scale;
  return t + k.bias;
}

template <typename T, int V, bool kRows>
__global__ void __launch_bounds__(kThreads) bn_apply_kernel(
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
  const int s = blockIdx.x;
  if constexpr (!kRows) {
    const int c = blockIdx.y;
    const Fwd<A> k = forward_coef<A>(sums, g.nc, c, eps, w, b);
    if (s == 0 && threadIdx.x == 0)
      write_stats(c, k, rm, rv, momentum, mean_out, invstd_out, rm_out,
                  rv_out);
    planes_each<V>(g, s, c, [&](long long off) {
      A v[V];
      load<T, V>(x + off, v);
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = normalise(v[q], k);
      store<T, V>(y + off, v);
    });
  } else {
    const int tw = g.tw, ry = blockDim.x / tw;
    const int tx = threadIdx.x % tw, ty = threadIdx.x / tw;
    const int col = blockIdx.y * tw + tx;
    if (col >= g.nc / V) return;
    Fwd<A> k[V];
#pragma unroll
    for (int q = 0; q < V; ++q) {
      k[q] = forward_coef<A>(sums, g.nc, col * V + q, eps, w, b);
      if (s == 0 && ty == 0)
        write_stats(col * V + q, k[q], rm, rv, momentum, mean_out,
                    invstd_out, rm_out, rv_out);
    }
    rows_each(g, s, ty, ry, [&](long long roff) {
      A v[V];
      load<T, V>(x + roff + col * V, v);
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = normalise(v[q], k[q]);
      store<T, V>(y + roff + col * V, v);
    });
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
    planes_each<V>(g, s, c, [&](long long off) {
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
    rows_each(g, s, ty, ry, [&](long long roff) {
      A dv[V], xv[V];
      load<T, V>(dy + roff + col * V, dv);
      load<T, V>(x + roff + col * V, xv);
#pragma unroll
      for (int q = 0; q < V; ++q) dv[q] = input_grad(dv[q], xv[q], k[q]);
      store<T, V>(dx + roff + col * V, dv);
    });
  }
}

// The launch shape of a geometry; false when a grid axis or a tile is out
// of range
bool shape_of(const Geo& g, bool rows, int v, dim3& grid, dim3& block) {
  if (g.slices < 1 || g.nc < 1 || g.span < 1) return false;
  if (rows) {
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
    block = dim3(kThreads);
  }
  return true;
}

Geo geo_of(long long outer, long long inner, long long span, int nc,
           int slices, int tw) {
  Geo g;
  g.outer = outer;
  g.inner = inner;
  g.span = span;
  g.nc = nc;
  g.slices = slices;
  g.tw = tw;
  return g;
}

// L::run<T, V, kRows>(args...) for the dtype code (0 float32, 1
// bfloat16, 2 float64, 3 float16), vec (16-byte accesses) and rows;
// false for another code
template <typename L, typename T, typename... Args>
void variants(bool vec, bool rows, Args... args) {
  constexpr int kV = 16 / sizeof(T);
  if (rows) {
    if (vec)
      L::template run<T, kV, true>(args...);
    else
      L::template run<T, 1, true>(args...);
  } else {
    if (vec)
      L::template run<T, kV, false>(args...);
    else
      L::template run<T, 1, false>(args...);
  }
}

template <typename L, typename... Args>
bool dispatch(int dtype, bool vec, bool rows, Args... args) {
  switch (dtype) {
    case 0:
      variants<L, float>(vec, rows, args...);
      return true;
    case 1:
      variants<L, __nv_bfloat16>(vec, rows, args...);
      return true;
    case 2:
      variants<L, double>(vec, rows, args...);
      return true;
    case 3:
      variants<L, __half>(vec, rows, args...);
      return true;
    default:
      return false;
  }
}

struct StatsLaunch {
  template <typename T, int V, bool R>
  static void run(dim3 grid, dim3 block, cudaStream_t st, const void* x,
                  Geo g, double* partials, unsigned* tickets, double* out) {
    bn_stats_kernel<T, V, R><<<grid, block, 0, st>>>(
        static_cast<const T*>(x), g, partials, tickets, out);
  }
};

struct ApplyLaunch {
  template <typename T, int V, bool R>
  static void run(dim3 grid, dim3 block, cudaStream_t st, const void* x,
                  void* y, Geo g, const double* sums, const void* w,
                  const void* b, const void* rm, const void* rv,
                  double momentum, double eps, void* mean_out,
                  void* invstd_out, void* rm_out, void* rv_out) {
    using A = typename AccOf<T>::type;
    bn_apply_kernel<T, V, R><<<grid, block, 0, st>>>(
        static_cast<const T*>(x), static_cast<T*>(y), g, sums,
        static_cast<const A*>(w), static_cast<const A*>(b),
        static_cast<const A*>(rm), static_cast<const A*>(rv), momentum, eps,
        static_cast<A*>(mean_out), static_cast<A*>(invstd_out),
        static_cast<A*>(rm_out), static_cast<A*>(rv_out));
  }
};

struct GradStatsLaunch {
  template <typename T, int V, bool R>
  static void run(dim3 grid, dim3 block, cudaStream_t st, const void* dy,
                  const void* x, Geo g, const void* mean, const void* invstd,
                  double* partials, unsigned* tickets, double* out, void* dw,
                  void* db) {
    using A = typename AccOf<T>::type;
    bn_grad_stats_kernel<T, V, R><<<grid, block, 0, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x), g,
        static_cast<const A*>(mean), static_cast<const A*>(invstd), partials,
        tickets, out, static_cast<A*>(dw), static_cast<A*>(db));
  }
};

struct GradApplyLaunch {
  template <typename T, int V, bool R>
  static void run(dim3 grid, dim3 block, cudaStream_t st, const void* dy,
                  const void* x, void* dx, Geo g, const double* gs,
                  const double* sums, const void* mean, const void* invstd,
                  const void* w) {
    using A = typename AccOf<T>::type;
    bn_grad_apply_kernel<T, V, R><<<grid, block, 0, st>>>(
        static_cast<const T*>(dy), static_cast<const T*>(x),
        static_cast<T*>(dx), g, gs, sums, static_cast<const A*>(mean),
        static_cast<const A*>(invstd), static_cast<const A*>(w));
  }
};

int dtype_width(int dtype) {
  return dtype == 0 ? 4 : dtype == 1 || dtype == 3 ? 2 : dtype == 2 ? 8 : 0;
}

}  // namespace

// The geometry arguments of every entry point: rows (0 planes, 1 rows),
// outer, inner, span, channels, slices, tw, vec (16-byte accesses)
#define STP_BN_GEO                                                       \
  int rows, long long outer, long long inner, long long span, int nc,    \
      int slices, int tw, int vec

#define STP_BN_SHAPE                                                     \
  Geo g = geo_of(outer, inner, span, nc, slices, tw);                    \
  int width = dtype_width(dtype);                                        \
  if (width == 0) return (int)cudaErrorInvalidValue;                     \
  dim3 grid, block;                                                      \
  if (!shape_of(g, rows != 0, vec ? 16 / width : 1, grid, block))        \
    return (int)cudaErrorInvalidValue;                                   \
  cudaStream_t st = (cudaStream_t)stream;

extern "C" int stp_bn_stats(const void* x, int dtype, STP_BN_GEO,
                            double* partials, unsigned* tickets, double* out,
                            void* stream) {
  STP_BN_SHAPE
  dispatch<StatsLaunch>(dtype, vec != 0, rows != 0, grid, block, st, x, g,
                        partials, tickets, out);
  return (int)cudaGetLastError();
}

extern "C" int stp_bn_apply(const void* x, void* y, int dtype, STP_BN_GEO,
                            const double* sums, const void* w, const void* b,
                            const void* rm, const void* rv, double momentum,
                            double eps, void* mean_out, void* invstd_out,
                            void* rm_out, void* rv_out, void* stream) {
  STP_BN_SHAPE
  dispatch<ApplyLaunch>(dtype, vec != 0, rows != 0, grid, block, st, x, y, g,
                        sums, w, b, rm, rv, momentum, eps, mean_out,
                        invstd_out, rm_out, rv_out);
  return (int)cudaGetLastError();
}

extern "C" int stp_bn_grad_stats(const void* dy, const void* x, int dtype,
                                 STP_BN_GEO, const void* mean,
                                 const void* invstd, double* partials,
                                 unsigned* tickets, double* out, void* dw,
                                 void* db, void* stream) {
  STP_BN_SHAPE
  dispatch<GradStatsLaunch>(dtype, vec != 0, rows != 0, grid, block, st, dy,
                            x, g, mean, invstd, partials, tickets, out, dw,
                            db);
  return (int)cudaGetLastError();
}

extern "C" int stp_bn_grad_apply(const void* dy, const void* x, void* dx,
                                 int dtype, STP_BN_GEO, const double* gs,
                                 const double* sums, const void* mean,
                                 const void* invstd, const void* w,
                                 void* stream) {
  STP_BN_SHAPE
  dispatch<GradApplyLaunch>(dtype, vec != 0, rows != 0, grid, block, st, dy,
                            x, dx, g, gs, sums, mean, invstd, w);
  return (int)cudaGetLastError();
}
