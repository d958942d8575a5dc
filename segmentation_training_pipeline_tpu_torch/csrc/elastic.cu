// Bounded-displacement joint resample (elastic warp) for Hopper (sm_90a).
//
// Replaces the TPU kernel segmentation_training_pipeline_tpu/ops/aug/
// pallas_elastic.py:_elastic_joint_kernel (launched from
// elastic_resample_joint_tpu).  The TPU version keeps a y-padded plane in
// VMEM and range-selects over the 2K+1 integer row offsets, then resamples
// x with lane rolls (or a windowed dynamic_gather when K <= 30).  Both TPU
// branches compute the same separable function, which this kernel computes
// directly:
//
//   R(y, x')  = (1 - fy) * P[y + iy, x'] + fy * P[y + iy + 1, x']
//               with (iy, fy) from dy at (y, x') -- that column's own dy
//   out(y, x) = (1 - fx) * R(y, x + ix) + fx * R(y, x + ix + 1)
//               with (ix, fx) from dx at (y, x)
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
// 3.35 TB/s).  A thread per output, as the first version ran, computed
// two row blends per output and each R(y, x') once for every output whose
// x-taps land on x', read dy and dx once per channel and paid 64-bit
// divisions for its index: four times the bound.
//
// The design is kernel YE's tile (warp_xy.cu) without the y-warp: one
// block per (image, tile of T rows) over the full width, on a 3-D grid
// with 32-bit index math.  The block stages the tile's dy and dx in shared
// memory once per image (16-byte loads where W % 4 == 0 and the fields are
// aligned), then for each channel computes every R of the
// tile exactly once into shared memory (two plane reads each, coalesced
// along x'; the rows are unrolled so a thread's loads are in flight
// together) and forms each output from two shared-memory reads and one
// x-blend.  Full-width tiles make the mod-W wrap a shared-memory index.
// T is the largest of 2, 1 whose three T x W f32 tiles fit 48 KB; wider
// rows take T = 1 in up to 227 KB of dynamic shared memory (W <= 19370),
// and the wrapper refuses a wider row.  Two-row tiles of 256 threads
// measured fastest at 512^2 (PERF.md §6): taller tiles and wider blocks
// leave fewer blocks to overlap each other's barriers.  What is left to the
// bound is latency, not bytes or arithmetic: without its plane reads the
// kernel still takes more than half its time, 1.8 times the byte bound of
// what it then moves, in the barrier-separated phases of a short block
// (stage, then blend and write for each channel).  Branch-free row blends,
// two channels a phase and two columns a thread were no faster.

#include <cuda_runtime.h>

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kMaxSmem = 232448;      // a block's shared-memory ceiling
constexpr int kStaticSmem = 48 * 1024;
constexpr int kMaxRows = 2;
constexpr int kMaxThreads = 256;

// The tap along one axis at index i of n from the raw displacement v: the
// integer offset, and in f its fraction, rounded for nearest channels.
// i + offset lies in [0, n - 1]: the clamp keeps i + v in [0, n - 1], and
// the rounded subtraction and the floor are monotone and keep the integer
// ends -i and n - 1 - i.
__device__ __forceinline__ int tap(float v, int i, int n, bool is_near,
                                   float& f) {
  float fi = (float)i;
  float d = fminf(fmaxf(fi + v, 0.0f), (float)n - 1.0f) - fi;
  float id = floorf(d);
  f = d - id;
  if (is_near) f = floorf(f + 0.5f);
  return (int)id;
}

__device__ __forceinline__ float plane_at(const float* plane, int r, int x,
                                          int h, int w, float fill) {
  return (r >= 0 && r < h) ? plane[(size_t)r * w + x] : fill;
}

// R(y, x) with the dy of column x (dyv); 0 when the integer offset lies
// outside [-K, K]
__device__ __forceinline__ float row_at(const float* plane, float dyv, int y,
                                        int x, int h, int w, int k,
                                        bool is_near, float fill) {
  float fy;
  int s = tap(dyv, y, h, is_near, fy);
  if (s < -k || s > k) return 0.0f;
  float a = plane_at(plane, y + s, x, h, w, fill);
  float b = plane_at(plane, y + s + 1, x, h, w, fill);
  return (1.0f - fy) * a + fy * b;
}

// Rows per tile at width w (0 when one row cannot fit): the dy, dx and
// row-blend tiles take 3 * rows * w floats.
int tile_rows(int w) {
  long long row_bytes = 3LL * sizeof(float) * w;
  if (row_bytes > kMaxSmem) return 0;
  int t = kMaxRows;
  while (t > 1 && t * row_bytes > kStaticSmem) t /= 2;
  return t;
}

__global__ void __launch_bounds__(kMaxThreads)
    elastic_kernel(const float* __restrict__ planes,
                   const int* __restrict__ flags,
                   const float* __restrict__ dy, const float* __restrict__ dx,
                   float* __restrict__ out, int nc, int h, int w, int k,
                   int tile, bool vec, float fill) {
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                  // tile x w each
  float* dxs = smem + tile * w;
  float* rs = smem + 2 * tile * w;    // the row blends of one channel
  int b = blockIdx.z;
  int y0 = blockIdx.y * tile;
  int rows = min(tile, h - y0);
  size_t fbase = ((size_t)b * h + y0) * w;
  if (vec) {   // 16-byte loads: w % 4 == 0 and dy, dx aligned
    const float4* dy4 = reinterpret_cast<const float4*>(dy + fbase);
    const float4* dx4 = reinterpret_cast<const float4*>(dx + fbase);
    for (int p = threadIdx.x; p < rows * w / 4; p += blockDim.x) {
      reinterpret_cast<float4*>(dys)[p] = dy4[p];
      reinterpret_cast<float4*>(dxs)[p] = dx4[p];
    }
  } else {
    for (int p = threadIdx.x; p < rows * w; p += blockDim.x) {
      dys[p] = dy[fbase + p];
      dxs[p] = dx[fbase + p];
    }
  }
  __syncthreads();

  for (int c = 0; c < nc; ++c) {
    bool is_near = flags[c] != 0;
    size_t pbase = ((size_t)b * nc + c) * h * w;
    const float* plane = planes + pbase;
    // every row blend of the tile, once; the rows are unrolled so that a
    // thread's plane loads are in flight together
    for (int x = threadIdx.x; x < w; x += blockDim.x) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r >= rows) break;
        rs[r * w + x] = row_at(plane, dys[r * w + x], y0 + r, x, h, w, k,
                               is_near, fill);
      }
    }
    __syncthreads();
    // the outputs: x-blends of two row blends
    for (int x = threadIdx.x; x < w; x += blockDim.x) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r >= rows) break;
        int y = y0 + r;
        float dyr = dys[r * w + x];
        float dxr = dxs[r * w + x];
        float sy = (float)y + dyr;
        float sx = (float)x + dxr;
        float res = fill;
        if (!(sy < -0.5f || sy > (float)h - 0.5f || sx < -0.5f ||
              sx > (float)w - 0.5f)) {
          float fx;
          int s = tap(dxr, x, w, is_near, fx);
          res = 0.0f;
          if (s >= -k && s <= k) {
            int x0 = x + s;   // in [0, w - 1] (tap); only x0 + 1 can wrap
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

// Lets the kernel take `smem` bytes of dynamic shared memory: above the
// static 48 KB the limit is raised first.
bool allow_smem(size_t smem) {
  return smem <= (size_t)kStaticSmem ||
         cudaFuncSetAttribute(elastic_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem) == cudaSuccess;
}

}  // namespace

extern "C" int stp_elastic(const float* planes, const int* flags,
                           const float* dy, const float* dx, float* out,
                           int nb, int nc, int h, int w, int k, float fill,
                           void* stream) {
  if ((long long)nb * nc * h * w == 0) return (int)cudaGetLastError();
  int tile = tile_rows(w);
  if (tile == 0 || nb > 65535 || (h + tile - 1) / tile > 65535)
    return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)3 * tile * w * sizeof(float);
  if (!allow_smem(smem)) return (int)cudaErrorInvalidValue;
  int threads = std::min(kMaxThreads, (w + 31) / 32 * 32);
  bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(dy) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  dim3 grid(1, (h + tile - 1) / tile, nb);
  elastic_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      planes, flags, dy, dx, out, nc, h, w, k, tile, vec, fill);
  return (int)cudaGetLastError();
}
