// Fused affine warp for Hopper (sm_90a): kernel X (x-pad, x-shear,
// x-scale+translate) and kernel Y (y-scale+translate, y-shear, row slice).
//
// Replaces the TPU kernels segmentation_training_pipeline_tpu/ops/aug/
// pallas_warp.py:_warp_x_kernel and :_warp_y_kernel (launched from
// warp_fused_tpu).  The TPU versions keep a whole (b, c) plane in VMEM and
// express the shears as log-shift lane/sublane rolls and the scale passes
// as MXU dots against in-kernel tap matrices.  None of that carries over:
// every output pixel here is computed by one thread with direct index math
// in f32 from at most four input pixels of one row (X) or one column (Y).
// The intermediate sheared canvas is never materialised; a thread
// recomputes the two canvas taps it needs.
//
// Bound on an H100: memory.  Each launch reads the (B, C, H, W) f32 planes
// once and writes them once (at B16 C4 512^2: 64 MiB + 64 MiB, about 40 us
// at 3.35 TB/s); the arithmetic is ~40 flops per pixel.  This first
// version relies on L1/L2 for the neighbouring-tap reuse (threads of a warp
// run along W, so the row reads of kernel X and the column reads of kernel
// Y are coalesced); shared-memory staging or TMA is left for later work.
//
// Numerics follow the TPU kernel operation by operation: floor-based
// nearest rounding (floorf(f + 0.5f), never rintf) for mask channels, the
// same left-to-right evaluation order, and the build passes -fmad=false so
// no multiply-add is contracted into an FMA (a contraction can move a
// coordinate across a .5 tie and flip a mask pixel).
//
// Layout: planes (B, C, H, W) f32 contiguous; kinds (C,) i32 (0 bilinear
// image channel, 1 nearest mask channel); scal (B, 6) f32 per image =
// (s1, e1, tx, e2, ty, s2), tx/ty already centre-adjusted by the caller.

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
  int hp = h + 2 * py;
  bool is_mask = kinds[c] == 1;
  float e2 = scal[b * 6 + 3];
  float ty = scal[b * 6 + 4];
  float s2 = scal[b * 6 + 5];
  const float* plane = planes + ((long long)b * nc + c) * h * w;

  // y-shear quantities of this column (pallas_warp.py step 5)
  float cx = (float)(w - 1) / 2.0f;
  float offs = s2 * ((float)j - cx);
  float kfloor = floorf(offs);
  float frac = offs - kfloor;
  if (is_mask) frac = floorf(frac + 0.5f);
  int kmod = floor_mod((int)kfloor, hp);

  int r = i + py;  // output row i is canvas row py + i (step 6)
  float src = (float)r + offs;
  float res;
  if (src < -0.5f || src > (float)hp - 0.5f) {
    res = fill;
  } else {
    int a = floor_mod(r + kmod, hp);
    int a1 = floor_mod(a + 1, hp);
    float o = scaled_y(plane, a, j, h, w, py, e2, ty, is_mask, fill);
    float n = scaled_y(plane, a1, j, h, w, py, e2, ty, is_mask, fill);
    res = (1.0f - frac) * o + frac * n;
    if (src >= (float)hp - 1.0f) res = o;
    if (src < 0.0f) res = n;
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
