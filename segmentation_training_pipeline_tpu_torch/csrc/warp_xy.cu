// Fused affine warp for Hopper (sm_90a): kernel X (x-pad, x-shear,
// x-scale+translate), kernel Y (y-scale+translate, y-shear, row slice) and
// kernel YE (kernel Y with the elastic resample fused into the launch).
//
// Replaces the TPU kernels segmentation_training_pipeline_tpu/ops/aug/
// pallas_warp.py:_warp_x_kernel, :_warp_y_kernel and :_warp_ye_kernel
// (launched from warp_fused_tpu).  The TPU versions keep a whole (b, c)
// plane in VMEM and express the shears as log-shift lane/sublane rolls and
// the scale passes as MXU dots against in-kernel tap matrices.  None of
// that carries over: every output pixel here is computed by one thread with
// direct index math in f32 from at most four input pixels of one row (X)
// or one column (Y).  The intermediate sheared canvas is never
// materialised; a thread recomputes the two canvas taps it needs.
//
// Kernel YE: output (y, x) is the separable elastic resample of the
// y-sheared canvas (the whole H + 2py rows, of which kernel Y keeps rows
// [py, py + H)).  It x-blends the row blend at columns x + ix and
// x + ix + 1 (mod W), each row blend taken with that column's own dy from
// canvas rows py + y + iy and py + y + iy + 1; an integer offset outside
// [-K, K] adds 0 and the fill test uses the raw displacement
// (pallas_warp.py:_warp_ye_kernel).  The clamp of y + dy to [0, H - 1]
// keeps every tap inside the canvas when py >= K + 1 (the caller checks).
// A thread recomputes its four canvas values from kernel Y's arithmetic:
// 16 plane reads per output pixel, all from two columns, left to L1/L2.
//
// Bound on an H100: memory.  Each launch of X or Y reads the (B, C, H, W)
// f32 planes once and writes them once (at B16 C4 512^2: 64 MiB + 64 MiB,
// about 40 us at 3.35 TB/s); YE also reads the (B, H, W) dy and dx fields
// (another 32 MiB, about 50 us in all); the arithmetic is ~40 flops per
// pixel for X and Y and ~200 for YE.  This first version relies on L1/L2
// for the neighbouring-tap reuse (threads of a warp run along W, so the
// row reads of kernel X and the column reads of kernels Y and YE are
// coalesced); shared-memory staging or TMA is left for later work.
//
// Numerics follow the TPU kernel operation by operation: floor-based
// nearest rounding (floorf(f + 0.5f), never rintf) for mask channels, the
// same left-to-right evaluation order, and the build passes -fmad=false so
// no multiply-add is contracted into an FMA (a contraction can move a
// coordinate across a .5 tie and flip a mask pixel).
//
// Layout: planes (B, C, H, W) f32 contiguous; kinds (C,) i32 (0 bilinear
// image channel, 1 nearest mask channel); scal (B, 6) f32 per image =
// (s1, e1, tx, e2, ty, s2), tx/ty already centre-adjusted by the caller;
// dy, dx (B, H, W) f32 (YE only).

#include <cuda_runtime.h>

namespace {

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

// Value of the x-sheared canvas at column q of one row: the canvas holds
// P[(q + kmod) mod wp] blended with its right neighbour, edge-clamped and
// fill outside the original frame (pallas_warp.py step 2).
__device__ __forceinline__ float sheared_x(const float* row, int q, int wp,
                                           int px, int w, float offs,
                                           float frac, int kmod,
                                           float fill) {
  float src = ((float)q + offs) - (float)px;
  if (src < -0.5f || src > (float)w - 0.5f) return fill;
  int a = floor_mod(q + kmod, wp);
  int a1 = floor_mod(a + 1, wp);
  float o = padded_x(row, a, px, w, fill);
  float n = padded_x(row, a1, px, w, fill);
  float res = (1.0f - frac) * o + frac * n;
  if (src >= (float)w - 1.0f) res = o;
  if (src < 0.0f) res = n;
  return res;
}

__global__ void warp_x_kernel(const float* __restrict__ planes,
                              const int* __restrict__ kinds,
                              const float* __restrict__ scal,
                              float* __restrict__ out, int nb, int nc,
                              int h, int w, int px, float fill) {
  long long total = (long long)nb * nc * h * w;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int j = (int)(idx % w);
  int i = (int)((idx / w) % h);
  int c = (int)((idx / ((long long)w * h)) % nc);
  int b = (int)(idx / ((long long)w * h * nc));
  int wp = w + 2 * px;
  bool is_mask = kinds[c] == 1;
  float s1 = scal[b * 6 + 0];
  float e1 = scal[b * 6 + 1];
  float tx = scal[b * 6 + 2];
  const float* row = planes + (((long long)b * nc + c) * h + i) * w;

  // x-shear quantities of this row
  float cy = (float)(h - 1) / 2.0f;
  float offs = s1 * ((float)i - cy);
  float kfloor = floorf(offs);
  float frac = offs - kfloor;
  if (is_mask) frac = floorf(frac + 0.5f);
  int kmod = floor_mod((int)kfloor, wp);

  // x-scale+translate: dst column j reads canvas column e1*j + tx + px
  float col = (e1 * (float)j + tx) + (float)px;
  float res;
  if (!(col >= -0.5f && col <= (float)wp - 0.5f)) {
    res = fill;
  } else if (col < 0.0f) {
    res = sheared_x(row, 0, wp, px, w, offs, frac, kmod, fill);
  } else if (col >= (float)wp - 1.0f) {
    res = sheared_x(row, wp - 1, wp, px, w, offs, frac, kmod, fill);
  } else {
    float s0 = floorf(col);
    float f = col - s0;
    if (is_mask) f = floorf(f + 0.5f);
    int q = (int)s0;
    float c0 = sheared_x(row, q, wp, px, w, offs, frac, kmod, fill);
    float c1 = sheared_x(row, q + 1, wp, px, w, offs, frac, kmod, fill);
    res = (1.0f - f) * c0 + f * c1;
  }
  out[idx] = res;
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

// Value of the y-sheared canvas (H + 2py rows) at canvas row r, column j
// of one plane: the y-scaled canvas at (r + kmod) mod hp blended with the
// next row, edge-clamped, fill outside the canvas.
__device__ __forceinline__ float sheared_y(const float* plane, int r, int j,
                                           int h, int w, int py, float e2,
                                           float ty, YShear t, bool is_mask,
                                           float fill) {
  int hp = h + 2 * py;
  float src = (float)r + t.offs;
  if (src < -0.5f || src > (float)hp - 0.5f) return fill;
  int a = floor_mod(r + t.kmod, hp);
  int a1 = floor_mod(a + 1, hp);
  float o = scaled_y(plane, a, j, h, w, py, e2, ty, is_mask, fill);
  float n = scaled_y(plane, a1, j, h, w, py, e2, ty, is_mask, fill);
  float res = (1.0f - t.frac) * o + t.frac * n;
  if (src >= (float)hp - 1.0f) res = o;
  if (src < 0.0f) res = n;
  return res;
}

__global__ void warp_y_kernel(const float* __restrict__ planes,
                              const int* __restrict__ kinds,
                              const float* __restrict__ scal,
                              float* __restrict__ out, int nb, int nc,
                              int h, int w, int py, float fill) {
  long long total = (long long)nb * nc * h * w;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int j = (int)(idx % w);
  int i = (int)((idx / w) % h);
  int c = (int)((idx / ((long long)w * h)) % nc);
  int b = (int)(idx / ((long long)w * h * nc));
  bool is_mask = kinds[c] == 1;
  float e2 = scal[b * 6 + 3];
  float ty = scal[b * 6 + 4];
  YShear t = y_shear(scal[b * 6 + 5], j, w, h + 2 * py, is_mask);
  const float* plane = planes + ((long long)b * nc + c) * h * w;
  // output row i is canvas row py + i (step 6)
  out[idx] = sheared_y(plane, i + py, j, h, w, py, e2, ty, t, is_mask, fill);
}

// Row blend of the elastic tail at (y, xc) from the y-sheared canvas, with
// the dy of column xc; 0 when the integer offset lies outside [-K, K].
__device__ __forceinline__ float ye_row(const float* plane, const float* dyb,
                                        int y, int xc, int h, int w, int py,
                                        int k, float e2, float ty, float s2,
                                        bool is_mask, float fill) {
  float yf = (float)y;
  float d = fminf(fmaxf(yf + dyb[(long long)y * w + xc], 0.0f),
                  (float)h - 1.0f) - yf;
  float iy = floorf(d);
  float fy = d - iy;
  if (is_mask) fy = floorf(fy + 0.5f);
  int s = (int)iy;
  if (s < -k || s > k) return 0.0f;
  YShear t = y_shear(s2, xc, w, h + 2 * py, is_mask);
  float a = sheared_y(plane, py + y + s, xc, h, w, py, e2, ty, t, is_mask,
                      fill);
  float b = sheared_y(plane, py + y + s + 1, xc, h, w, py, e2, ty, t,
                      is_mask, fill);
  return (1.0f - fy) * a + fy * b;
}

__global__ void warp_ye_kernel(const float* __restrict__ planes,
                               const int* __restrict__ kinds,
                               const float* __restrict__ scal,
                               const float* __restrict__ dy,
                               const float* __restrict__ dx,
                               float* __restrict__ out, int nb, int nc,
                               int h, int w, int py, int k, float fill) {
  long long total = (long long)nb * nc * h * w;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int x = (int)(idx % w);
  int y = (int)((idx / w) % h);
  int c = (int)((idx / ((long long)w * h)) % nc);
  int b = (int)(idx / ((long long)w * h * nc));
  bool is_mask = kinds[c] == 1;
  const float* dyb = dy + (long long)b * h * w;
  const float* dxb = dx + (long long)b * h * w;
  float dyr = dyb[(long long)y * w + x];
  float dxr = dxb[(long long)y * w + x];
  float sy = (float)y + dyr;
  float sx = (float)x + dxr;
  if (sy < -0.5f || sy > (float)h - 0.5f || sx < -0.5f ||
      sx > (float)w - 0.5f) {
    out[idx] = fill;
    return;
  }
  float xf = (float)x;
  float d = fminf(fmaxf(xf + dxr, 0.0f), (float)w - 1.0f) - xf;
  float ix = floorf(d);
  float fx = d - ix;
  if (is_mask) fx = floorf(fx + 0.5f);
  int s = (int)ix;
  float res = 0.0f;
  if (s >= -k && s <= k) {
    float e2 = scal[b * 6 + 3];
    float ty = scal[b * 6 + 4];
    float s2 = scal[b * 6 + 5];
    const float* plane = planes + ((long long)b * nc + c) * h * w;
    int x0 = floor_mod(x + s, w);
    int x1 = floor_mod(x0 + 1, w);
    float r0 = ye_row(plane, dyb, y, x0, h, w, py, k, e2, ty, s2, is_mask,
                      fill);
    float r1 = ye_row(plane, dyb, y, x1, h, w, py, k, e2, ty, s2, is_mask,
                      fill);
    res = (1.0f - fx) * r0 + fx * r1;
  }
  out[idx] = res;
}

constexpr int kThreads = 256;

unsigned int blocks_for(long long total) {
  return (unsigned int)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int stp_warp_x(const float* planes, const int* kinds,
                          const float* scal, float* out, int nb, int nc,
                          int h, int w, int px, float fill, void* stream) {
  long long total = (long long)nb * nc * h * w;
  if (total > 0) {
    warp_x_kernel<<<blocks_for(total), kThreads, 0,
                    (cudaStream_t)stream>>>(planes, kinds, scal, out, nb, nc,
                                            h, w, px, fill);
  }
  return (int)cudaGetLastError();
}

extern "C" int stp_warp_y(const float* planes, const int* kinds,
                          const float* scal, float* out, int nb, int nc,
                          int h, int w, int py, float fill, void* stream) {
  long long total = (long long)nb * nc * h * w;
  if (total > 0) {
    warp_y_kernel<<<blocks_for(total), kThreads, 0,
                    (cudaStream_t)stream>>>(planes, kinds, scal, out, nb, nc,
                                            h, w, py, fill);
  }
  return (int)cudaGetLastError();
}

extern "C" int stp_warp_ye(const float* planes, const int* kinds,
                           const float* scal, const float* dy,
                           const float* dx, float* out, int nb, int nc,
                           int h, int w, int py, int k, float fill,
                           void* stream) {
  long long total = (long long)nb * nc * h * w;
  if (total > 0) {
    warp_ye_kernel<<<blocks_for(total), kThreads, 0,
                     (cudaStream_t)stream>>>(planes, kinds, scal, dy, dx,
                                             out, nb, nc, h, w, py, k, fill);
  }
  return (int)cudaGetLastError();
}
