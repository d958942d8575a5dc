// Fused affine warp for Hopper (sm_90a): kernel X (x-pad, x-shear,
// x-scale+translate), kernel Y (y-scale+translate, y-shear, row slice) and
// kernel YE (kernel Y with the elastic resample fused into the launch).
//
// Replaces the TPU kernels segmentation_training_pipeline_tpu/ops/aug/
// pallas_warp.py:_warp_x_kernel (X), :_warp_y_kernel (Y) and
// :_warp_ye_kernel (YE), launched from warp_fused_tpu.  The TPU versions
// keep a whole (b, c) plane in VMEM and express the shears as log-shift
// lane/sublane rolls and the scale passes as MXU dots against in-kernel tap
// matrices.  None of that carries over: every value here is a direct f32
// blend of at most two neighbours along one row (X) or one column (Y, YE).
//
// Bound on an H100: memory.  X and Y read the (B, C, H, W) f32 planes once
// and write them once (at B16 C4 512^2: 64 MiB + 64 MiB, 40 us at
// 3.35 TB/s); YE also reads the (B, H, W) dy and dx fields (50 us in all).
// What stands between X or YE and that bound is instructions and reuse,
// not bytes: each output needs tens of f32 operations and, for YE, six
// plane reads from a band of rows.
//
// Kernel X: one block per (plane, row) on a 3-D grid (blockIdx.z = b*C + c,
// blockIdx.y = row), so no thread divides a flat index.  The block stages
// its input row in shared memory (16-byte loads where W % 4 == 0 and the
// pointers are aligned), computes each of the W + 2px values of the
// x-sheared canvas row once into shared memory (the row's shear offset,
// fraction and modulo are block constants), then each output reads its two
// canvas taps from there and the row is written 16 bytes a thread.
//
// Kernel YE: output (y, x) x-blends the row blend R(y, x') at x' = x + ix
// and x + ix + 1 (mod W).  R(y, x') is the blend of y-sheared canvas rows
// py + y + iy and the next, with the dy of column x'; an integer offset
// outside [-K, K] adds 0 and the fill test uses the raw displacement
// (pallas_warp.py:_warp_ye_kernel).  The clamp of y + dy to [0, H - 1]
// keeps every tap inside the canvas when py >= K + 1 (the caller checks).
// One block per (b, tile of T output rows) over the full width: it stages
// the tile's dy and dx in shared memory once per image, then for each
// channel computes every R of the tile exactly once into shared memory
// (the two canvas rows share one of their three y-scaled values: 6 plane
// reads per R, all from column x', coalesced along the threads) and forms
// the outputs from two shared-memory reads.  Full-width tiles make the
// mod-W wrap a shared-memory index.  The y-shear constants of a column are
// computed once per column and channel, not per tap.  T is the largest of
// 8, 4, 2, 1 whose three T x W f32 tiles fit 48 KB; wider rows take T = 1
// in up to 227 KB of dynamic shared memory (W <= 19370), and the wrapper
// refuses a wider row.  What holds YE at four times its bound is the
// arithmetic of the row blends, not their reads (PERF.md §6): by a
// count of the source, the three y-scaled values behind each R take some
// 80 of its ~140 instructions.  Staging each y-scaled value once per
// (canvas row, column) in a per-warp band of shared memory cut that count
// but not the time: the band left room for 2 blocks an SM, not 3.
//
// Kernel Y: a thread per (plane, column, tile of 8 output rows) on a 3-D
// grid (blockIdx.z = b*C + c, blockIdx.y = the row tile, blockIdx.x = a
// block of 128 columns) with 32-bit index math; the column's y-shear
// offset, fraction and modulo are computed once per thread, e2 and ty read
// once.  Output rows i and i + 1 of a column share a y-scaled value (the
// upper one of row i is the lower one of row i + 1), so the thread walks
// its column and carries it over: one y-scaled value (two plane loads) and
// one y-shear blend per output, where the first version computed two
// values from four loads and divided 64-bit indices.  The walk is unrolled
// over its 8 rows and its y-scaled value is branch-free (both rows load
// from clamped indices, the edge cases are selected after the blend), so a
// thread has its loads in flight together.  Loads and stores coalesce
// along the columns of a warp; adjacent columns differ in kmod by
// |s2| <= 0.36 rows, so a warp's load touches up to 12 rows and L1 serves
// the rest of the walk.  What is left to the bound is the rate of the
// read-then-write stream itself: with every kmod forced to 0, so that a
// warp reads one row, the kernel is only some 4% faster, and it takes
// 1.3 times a device copy of the same planes.  Keeping the last two
// plane rows in registers, keyed by row index, was slower (10 more
// registers and divergent branches), and so were taller row tiles.
//
// No tensor cores: the work is exact f32 interpolation with data-dependent
// taps, and a wgmma product would round its inputs to TF32 or bf16, which
// moves coordinates and mask ties.
//
// Numerics follow the TPU kernel operation by operation: floor-based
// nearest rounding (floorf(f + 0.5f), never rintf) for mask channels, the
// same left-to-right evaluation order, and the build passes -fmad=false so
// no multiply-add is contracted into an FMA (a contraction can move a
// coordinate across a .5 tie and flip a mask pixel).  The redesigns changed
// only index math, data movement and reuse, so X, Y and YE stay bit for
// bit equal to their plain versions.
//
// Layout: planes (B, C, H, W) f32 contiguous; kinds (C,) i32 (0 bilinear
// image channel, 1 nearest mask channel); scal (B, 6) f32 per image =
// (s1, e1, tx, e2, ty, s2), tx/ty already centre-adjusted by the caller;
// dy, dx (B, H, W) f32 (YE only).

#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxSmem = 232448;      // a block's shared-memory ceiling
constexpr int kStaticSmem = 48 * 1024;

__device__ __forceinline__ int floor_mod(int a, int n) {
  int r = a % n;
  return r < 0 ? r + n : r;
}

// x-padded row value at canvas column q (fill outside the original frame)
__device__ __forceinline__ float padded_x(const float* row, int q, int px,
                                          int w, float fill) {
  int s = q - px;
  return (s >= 0 && s < w) ? row[s] : fill;
}

// Value of the x-sheared canvas at column q in [0, wp) of one row: the
// canvas holds P[(q + kmod) mod wp] blended with its right neighbour,
// edge-clamped and fill outside the original frame (pallas_warp.py step 2).
__device__ __forceinline__ float sheared_x(const float* row, int q, int wp,
                                           int px, int w, float offs,
                                           float frac, int kmod,
                                           float fill) {
  float src = ((float)q + offs) - (float)px;
  if (src < -0.5f || src > (float)w - 0.5f) return fill;
  int a = wrap_once(q + kmod, wp);
  int a1 = wrap_once(a + 1, wp);
  float o = padded_x(row, a, px, w, fill);
  float n = padded_x(row, a1, px, w, fill);
  float res = (1.0f - frac) * o + frac * n;
  if (src >= (float)w - 1.0f) res = o;
  if (src < 0.0f) res = n;
  return res;
}

// x-scale+translate: destination column j reads canvas column e1*j + tx + px
__device__ __forceinline__ float scaled_x(const float* canvas, int j, int wp,
                                          int px, float e1, float tx,
                                          bool is_mask, float fill) {
  float col = (e1 * (float)j + tx) + (float)px;
  if (!(col >= -0.5f && col <= (float)wp - 0.5f)) return fill;
  if (col < 0.0f) return canvas[0];
  if (col >= (float)wp - 1.0f) return canvas[wp - 1];
  float s0 = floorf(col);
  float f = col - s0;
  if (is_mask) f = floorf(f + 0.5f);
  int q = (int)s0;
  return (1.0f - f) * canvas[q] + f * canvas[q + 1];
}

constexpr int kXThreads = 128;

template <bool kVec>
__global__ void __launch_bounds__(kXThreads)
    warp_x_kernel(const float* __restrict__ planes,
                  const int* __restrict__ kinds,
                  const float* __restrict__ scal, float* __restrict__ out,
                  int nc, int h, int w, int px, float fill) {
  extern __shared__ __align__(16) float smem[];
  float* row = smem;                      // the input row, w floats
  float* canvas = smem + ((w + 3) & ~3);  // the x-sheared row, wp floats
  int i = blockIdx.y;
  int plane = blockIdx.z;
  int b = plane / nc;
  int c = plane - b * nc;
  int wp = w + 2 * px;
  size_t base = ((size_t)plane * h + i) * w;

  if (kVec) {
    const float4* src = reinterpret_cast<const float4*>(planes + base);
    for (int q = threadIdx.x; q < w / 4; q += blockDim.x)
      reinterpret_cast<float4*>(row)[q] = src[q];
  } else {
    for (int q = threadIdx.x; q < w; q += blockDim.x)
      row[q] = planes[base + q];
  }

  // x-shear quantities of this row
  bool is_mask = kinds[c] == 1;
  float e1 = scal[b * 6 + 1];
  float tx = scal[b * 6 + 2];
  float cy = (float)(h - 1) / 2.0f;
  float offs = scal[b * 6 + 0] * ((float)i - cy);
  float kfloor = floorf(offs);
  float frac = offs - kfloor;
  if (is_mask) frac = floorf(frac + 0.5f);
  int kmod = floor_mod((int)kfloor, wp);
  __syncthreads();

  for (int q = threadIdx.x; q < wp; q += blockDim.x)
    canvas[q] = sheared_x(row, q, wp, px, w, offs, frac, kmod, fill);
  __syncthreads();

  if (kVec) {
    float4* dst = reinterpret_cast<float4*>(out + base);
    for (int q = threadIdx.x; q < w / 4; q += blockDim.x) {
      int j = 4 * q;
      float4 v;
      v.x = scaled_x(canvas, j, wp, px, e1, tx, is_mask, fill);
      v.y = scaled_x(canvas, j + 1, wp, px, e1, tx, is_mask, fill);
      v.z = scaled_x(canvas, j + 2, wp, px, e1, tx, is_mask, fill);
      v.w = scaled_x(canvas, j + 3, wp, px, e1, tx, is_mask, fill);
      dst[q] = v;
    }
  } else {
    for (int j = threadIdx.x; j < w; j += blockDim.x)
      out[base + j] = scaled_x(canvas, j, wp, px, e1, tx, is_mask, fill);
  }
}

// Value of the y-scaled canvas (H + 2py rows) at row r, column j of one
// plane (pallas_warp.py step 4): source row e2*(r - py) + ty, edge clamps
// and validity against the original H frame.
__device__ __forceinline__ float scaled_y(const float* plane, int r, int j,
                                          int h, int w, int py, float e2,
                                          float ty, bool is_mask,
                                          float fill) {
  float srcy = e2 * ((float)r - (float)py) + ty;
  if (!(srcy >= -0.5f && srcy <= (float)h - 0.5f)) return fill;
  if (srcy < 0.0f) return plane[j];
  if (srcy >= (float)h - 1.0f) return plane[(long long)(h - 1) * w + j];
  float s0 = floorf(srcy);
  float f = srcy - s0;
  if (is_mask) f = floorf(f + 0.5f);
  int q = (int)s0;
  float a = plane[(long long)q * w + j];
  float b = plane[(long long)(q + 1) * w + j];
  return (1.0f - f) * a + f * b;
}

// y-shear quantities of column j (pallas_warp.py step 5)
struct YShear {
  float offs, frac;
  int kmod;
};

__device__ __forceinline__ YShear y_shear(float s2, int j, int w, int hp,
                                          bool is_mask) {
  float cx = (float)(w - 1) / 2.0f;
  YShear t;
  t.offs = s2 * ((float)j - cx);
  float kfloor = floorf(t.offs);
  t.frac = t.offs - kfloor;
  if (is_mask) t.frac = floorf(t.frac + 0.5f);
  t.kmod = floor_mod((int)kfloor, hp);
  return t;
}

// scaled_y without branches, for kernel Y's walk: both rows load from
// clamped indices and the edge cases are selected after the blend, so the
// unrolled walk issues its loads ahead.  The same f32 operations in the
// same order give the value: row q0 is row 0 when srcy lies in [-0.5, 0)
// and row h - 1 when it lies in [h - 1, h - 0.5].  Outside [-0.5, h - 0.5]
// the clamp keeps the loads in the plane and the value is fill.
__device__ __forceinline__ float scaled_y_sel(const float* plane, int r,
                                              int j, int h, int w, int py,
                                              float e2, float ty,
                                              bool is_mask, float fill) {
  float srcy = e2 * ((float)r - (float)py) + ty;
  float s0 = floorf(srcy);
  float f = srcy - s0;
  if (is_mask) f = floorf(f + 0.5f);
  int q0 = min(max((int)s0, 0), h - 1);
  int q1 = min(q0 + 1, h - 1);
  float a = plane[(size_t)q0 * w + j];
  float b = plane[(size_t)q1 * w + j];
  float v = (1.0f - f) * a + f * b;
  if (srcy < 0.0f || srcy >= (float)h - 1.0f) v = a;
  if (!(srcy >= -0.5f && srcy <= (float)h - 0.5f)) v = fill;
  return v;
}

constexpr int kYRows = 8;       // output rows a thread walks
constexpr int kYThreads = 128;  // columns a block

// Kernel Y: a thread per (plane, column, tile of kYRows output rows).
// Output row i is the y-sheared canvas at row r = py + i (step 6): the
// blend of the y-scaled values at a = (r + kmod) mod hp and a + 1 (mod hp),
// edge-clamped, fill outside the canvas.  The next row's a is this row's
// a + 1, so the walk carries the upper value over as the next lower one
// and computes one y-scaled value a row.
__global__ void __launch_bounds__(kYThreads)
    warp_y_kernel(const float* __restrict__ planes,
                  const int* __restrict__ kinds,
                  const float* __restrict__ scal, float* __restrict__ out,
                  int nc, int h, int w, int py, float fill) {
  int j = blockIdx.x * kYThreads + threadIdx.x;
  if (j >= w) return;
  int p = blockIdx.z;
  int b = p / nc;
  int c = p - b * nc;
  int i0 = blockIdx.y * kYRows;
  int rows = min(kYRows, h - i0);
  bool is_mask = kinds[c] == 1;
  float e2 = scal[b * 6 + 3];
  float ty = scal[b * 6 + 4];
  int hp = h + 2 * py;
  YShear t = y_shear(scal[b * 6 + 5], j, w, hp, is_mask);
  const float* plane = planes + (size_t)p * h * w;
  float* dst = out + ((size_t)p * h + i0) * w + j;
  // r = py + i0 lies in [py, py + h - 1], inside [0, hp), and kmod in
  // [0, hp): their sum wraps at most once, and so does each a + 1
  int r = py + i0;
  int a = wrap_once(r + t.kmod, hp);
  float lo = scaled_y_sel(plane, a, j, h, w, py, e2, ty, is_mask, fill);
#pragma unroll
  for (int n = 0; n < kYRows; ++n, ++r) {
    if (n >= rows) break;
    a = wrap_once(a + 1, hp);
    float hi = scaled_y_sel(plane, a, j, h, w, py, e2, ty, is_mask, fill);
    float src = (float)r + t.offs;
    float res = fill;
    if (!(src < -0.5f || src > (float)hp - 0.5f)) {
      res = (1.0f - t.frac) * lo + t.frac * hi;
      if (src >= (float)hp - 1.0f) res = lo;
      if (src < 0.0f) res = hi;
    }
    dst[(size_t)n * w] = res;
    lo = hi;
  }
}

// The elastic tap along one axis at index i of n from the raw displacement
// v (elastic.py): the integer offset, and in f its fraction, rounded for
// masks.  i + offset lies in [0, n - 1]: after the clamp, the rounded
// subtraction and the floor are monotone and keep -i and n - 1 - i.
__device__ __forceinline__ int elastic_tap(float v, int i, int n,
                                           bool is_mask, float& f) {
  float fi = (float)i;
  float d = fminf(fmaxf(fi + v, 0.0f), (float)n - 1.0f) - fi;
  float id = floorf(d);
  f = d - id;
  if (is_mask) f = floorf(f + 0.5f);
  return (int)id;
}

// Kernel YE's row blend R(y, x) from canvas rows r = py + y + iy and r + 1
// of column x, with the dy of column x (dyv); 0 when the integer offset
// lies outside [-K, K].  The two y-sheared values are sheared_y(r) and
// sheared_y(r + 1), which share the y-scaled row (r + kmod + 1) mod hp.
// y + iy lies in [0, h - 1], so r and r + 1 lie in [0, hp) and every
// canvas index below is a sum of two indices in [0, hp).
__device__ __forceinline__ float ye_row(const float* plane, float dyv, int y,
                                        int x, int h, int w, int py, int k,
                                        float e2, float ty, YShear t,
                                        bool is_mask, float fill) {
  float fy;
  int s = elastic_tap(dyv, y, h, is_mask, fy);
  if (s < -k || s > k) return 0.0f;
  int hp = h + 2 * py;
  int r = py + y + s;
  float src0 = (float)r + t.offs;
  float src1 = (float)(r + 1) + t.offs;
  bool in0 = !(src0 < -0.5f || src0 > (float)hp - 0.5f);
  bool in1 = !(src1 < -0.5f || src1 > (float)hp - 0.5f);
  int a0 = wrap_once(r + t.kmod, hp);
  int a1 = wrap_once(a0 + 1, hp);
  int a2 = wrap_once(a1 + 1, hp);
  float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f;
  if (in0) v0 = scaled_y(plane, a0, x, h, w, py, e2, ty, is_mask, fill);
  if (in0 || in1)
    v1 = scaled_y(plane, a1, x, h, w, py, e2, ty, is_mask, fill);
  if (in1) v2 = scaled_y(plane, a2, x, h, w, py, e2, ty, is_mask, fill);
  float g0 = fill;   // sheared_y(r)
  if (in0) {
    g0 = (1.0f - t.frac) * v0 + t.frac * v1;
    if (src0 >= (float)hp - 1.0f) g0 = v0;
    if (src0 < 0.0f) g0 = v1;
  }
  float g1 = fill;   // sheared_y(r + 1)
  if (in1) {
    g1 = (1.0f - t.frac) * v1 + t.frac * v2;
    if (src1 >= (float)hp - 1.0f) g1 = v1;
    if (src1 < 0.0f) g1 = v2;
  }
  return (1.0f - fy) * g0 + fy * g1;
}

constexpr int kYEMaxRows = 8;
constexpr int kYEMaxThreads = 512;

// Rows per tile of kernel YE at width w (0 when one row cannot fit): the
// dy, dx and row-blend tiles take 3 * rows * w floats.
int ye_tile_rows(int w) {
  long long row_bytes = 3LL * sizeof(float) * w;
  if (row_bytes > kMaxSmem) return 0;
  int t = kYEMaxRows;
  while (t > 1 && t * row_bytes > kStaticSmem) t /= 2;
  return t;
}

__global__ void __launch_bounds__(kYEMaxThreads)
    warp_ye_kernel(const float* __restrict__ planes,
                   const int* __restrict__ kinds,
                   const float* __restrict__ scal,
                   const float* __restrict__ dy, const float* __restrict__ dx,
                   float* __restrict__ out, int nc, int h, int w, int py,
                   int k, int tile, float fill) {
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                  // tile x w each
  float* dxs = smem + tile * w;
  float* rs = smem + 2 * tile * w;    // the row blends of one channel
  int b = blockIdx.z;
  int y0 = blockIdx.y * tile;
  int rows = min(tile, h - y0);
  size_t fbase = ((size_t)b * h + y0) * w;
  for (int p = threadIdx.x; p < rows * w; p += blockDim.x) {
    dys[p] = dy[fbase + p];
    dxs[p] = dx[fbase + p];
  }
  float e2 = scal[b * 6 + 3];
  float ty = scal[b * 6 + 4];
  float s2 = scal[b * 6 + 5];
  int hp = h + 2 * py;
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    bool is_mask = kinds[c] == 1;
    size_t pbase = ((size_t)b * nc + c) * h * w;
    const float* plane = planes + pbase;
    // every row blend of the tile, once
    for (int x = threadIdx.x; x < w; x += blockDim.x) {
      YShear t = y_shear(s2, x, w, hp, is_mask);
      for (int r = 0; r < rows; ++r)
        rs[r * w + x] = ye_row(plane, dys[r * w + x], y0 + r, x, h, w, py,
                               k, e2, ty, t, is_mask, fill);
    }
    __syncthreads();
    // the outputs: x-blends of two row blends
    for (int r = 0; r < rows; ++r) {
      int y = y0 + r;
      for (int x = threadIdx.x; x < w; x += blockDim.x) {
        float dyr = dys[r * w + x];
        float dxr = dxs[r * w + x];
        float sy = (float)y + dyr;
        float sx = (float)x + dxr;
        float res = fill;
        if (!(sy < -0.5f || sy > (float)h - 0.5f || sx < -0.5f ||
              sx > (float)w - 0.5f)) {
          float fx;
          int s = elastic_tap(dxr, x, w, is_mask, fx);
          res = 0.0f;
          if (s >= -k && s <= k) {
            int x0 = x + s;   // in [0, w - 1]; only x0 + 1 can wrap
            int x1 = wrap_once(x0 + 1, w);
            res = (1.0f - fx) * rs[r * w + x0] + fx * rs[r * w + x1];
          }
        }
        out[pbase + (size_t)y * w + x] = res;
      }
    }
    __syncthreads();
  }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory: above the
// static 48 KB the limit is raised first.
template <typename Kernel>
bool allow_smem(Kernel kernel, size_t smem) {
  return smem <= (size_t)kStaticSmem ||
         cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem) == cudaSuccess;
}

}  // namespace

extern "C" int stp_warp_x(const float* planes, const int* kinds,
                          const float* scal, float* out, int nb, int nc,
                          int h, int w, int px, float fill, void* stream) {
  if ((long long)nb * nc * h * w == 0) return (int)cudaGetLastError();
  size_t smem = (size_t)(((w + 3) & ~3) + w + 2 * px) * sizeof(float);
  if (smem > (size_t)kMaxSmem || h > 65535 || (long long)nb * nc > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(1, h, nb * nc);
  cudaStream_t st = (cudaStream_t)stream;
  if (w % 4 == 0 && aligned16(planes) && aligned16(out)) {
    if (!allow_smem(warp_x_kernel<true>, smem))
      return (int)cudaErrorInvalidValue;
    warp_x_kernel<true><<<grid, kXThreads, smem, st>>>(
        planes, kinds, scal, out, nc, h, w, px, fill);
  } else {
    if (!allow_smem(warp_x_kernel<false>, smem))
      return (int)cudaErrorInvalidValue;
    warp_x_kernel<false><<<grid, kXThreads, smem, st>>>(
        planes, kinds, scal, out, nc, h, w, px, fill);
  }
  return (int)cudaGetLastError();
}

extern "C" int stp_warp_y(const float* planes, const int* kinds,
                          const float* scal, float* out, int nb, int nc,
                          int h, int w, int py, float fill, void* stream) {
  if ((long long)nb * nc * h * w == 0) return (int)cudaGetLastError();
  int tiles = (h + kYRows - 1) / kYRows;
  if (tiles > 65535 || (long long)nb * nc > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((w + kYThreads - 1) / kYThreads, tiles, nb * nc);
  warp_y_kernel<<<grid, kYThreads, 0, (cudaStream_t)stream>>>(
      planes, kinds, scal, out, nc, h, w, py, fill);
  return (int)cudaGetLastError();
}

extern "C" int stp_warp_ye(const float* planes, const int* kinds,
                           const float* scal, const float* dy,
                           const float* dx, float* out, int nb, int nc,
                           int h, int w, int py, int k, float fill,
                           void* stream) {
  if ((long long)nb * nc * h * w == 0) return (int)cudaGetLastError();
  int tile = ye_tile_rows(w);
  if (tile == 0 || nb > 65535) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)3 * tile * w * sizeof(float);
  if (!allow_smem(warp_ye_kernel, smem)) return (int)cudaErrorInvalidValue;
  int threads = std::min(kYEMaxThreads, (w + 31) / 32 * 32);
  dim3 grid(1, (h + tile - 1) / tile, nb);
  warp_ye_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      planes, kinds, scal, dy, dx, out, nc, h, w, py, k, tile, fill);
  return (int)cudaGetLastError();
}
