// Bounded-displacement joint resample (elastic warp) for Hopper (sm_90a).
//
// Replaces the TPU kernel segmentation_training_pipeline_tpu/ops/aug/
// pallas_elastic.py:_elastic_joint_kernel (launched from
// elastic_resample_joint_tpu).  The TPU version keeps a y-padded plane in
// VMEM and range-selects over the 2K+1 integer row offsets, then resamples
// x with lane rolls (or a windowed dynamic_gather when K <= 30).  Both TPU
// branches compute the same separable function, which this kernel computes
// directly, one thread per output pixel:
//
//   row(y, x') = (1 - fy) * P[y + iy, x'] + fy * P[y + iy + 1, x']
//                with (iy, fy) from dy at (y, x') -- that column's own dy
//   out(y, x)  = (1 - fx) * row(y, x + ix) + fx * row(y, x + ix + 1)
//                with (ix, fx) from dx at (y, x)
//
// Displacements are clamped so the sample stays in the frame, P is fill
// outside rows [0, H), an integer offset outside [-K, K] contributes 0 (the
// range-select finds no candidate), columns wrap mod W (the roll; the
// wrapped tap only ever carries weight 0), and a pixel whose unclamped
// source lies outside the frame is fill.  Mask channels round fy and fx
// with floorf(f + 0.5f) (never rintf: half-to-even would take the lower
// tap on a .5 tie), and the build passes -fmad=false.
//
// Bound on an H100: memory.  One launch reads the (B, C, H, W) f32 planes
// and the (B, H, W) dy, dx fields once and writes the planes once (at B16
// C4 512^2: 64 + 16 + 16 MiB read, 64 MiB written, about 50 us at
// 3.35 TB/s).  Each thread reads three field values and four plane values;
// neighbouring threads read neighbouring columns, so the reads coalesce
// and the reuse across threads is left to L1/L2 in this first version.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float plane_at(const float* plane, int r, int x,
                                          int h, int w, float fill) {
  return (r >= 0 && r < h) ? plane[(long long)r * w + x] : fill;
}

// y-resampled value at (y, xc), using the dy of column xc
__device__ __forceinline__ float row_at(const float* plane, const float* dy,
                                        int y, int xc, int h, int w, int k,
                                        bool is_near, float fill) {
  float yf = (float)y;
  float d = fminf(fmaxf(yf + dy[(long long)y * w + xc], 0.0f),
                  (float)h - 1.0f) - yf;
  float iy = floorf(d);
  float fy = d - iy;
  if (is_near) fy = floorf(fy + 0.5f);
  int s = (int)iy;
  if (s < -k || s > k) return 0.0f;
  float a = plane_at(plane, y + s, xc, h, w, fill);
  float b = plane_at(plane, y + s + 1, xc, h, w, fill);
  return (1.0f - fy) * a + fy * b;
}

__global__ void elastic_kernel(const float* __restrict__ planes,
                               const int* __restrict__ flags,
                               const float* __restrict__ dy,
                               const float* __restrict__ dx,
                               float* __restrict__ out, int nb, int nc,
                               int h, int w, int k, float fill) {
  long long total = (long long)nb * nc * h * w;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int x = (int)(idx % w);
  int y = (int)((idx / w) % h);
  int c = (int)((idx / ((long long)w * h)) % nc);
  int b = (int)(idx / ((long long)w * h * nc));
  bool is_near = flags[c] != 0;
  const float* plane = planes + ((long long)b * nc + c) * h * w;
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
  if (is_near) fx = floorf(fx + 0.5f);
  int s = (int)ix;
  float res = 0.0f;
  if (s >= -k && s <= k) {
    int x0 = (x + s) % w;
    if (x0 < 0) x0 += w;
    int x1 = (x0 + 1) % w;
    float r0 = row_at(plane, dyb, y, x0, h, w, k, is_near, fill);
    float r1 = row_at(plane, dyb, y, x1, h, w, k, is_near, fill);
    res = (1.0f - fx) * r0 + fx * r1;
  }
  out[idx] = res;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int stp_elastic(const float* planes, const int* flags,
                           const float* dy, const float* dx, float* out,
                           int nb, int nc, int h, int w, int k, float fill,
                           void* stream) {
  long long total = (long long)nb * nc * h * w;
  if (total > 0) {
    unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
    elastic_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        planes, flags, dy, dx, out, nb, nc, h, w, k, fill);
  }
  return (int)cudaGetLastError();
}
