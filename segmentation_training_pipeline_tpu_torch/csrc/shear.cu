// Shear resample along the last axis for Hopper (sm_90a): one pass of the
// unfused multipass warp (the x-shear on the x-padded canvas, or the
// y-shear on the y-padded canvas after the caller's transpose).
//
// Replaces the TPU kernel segmentation_training_pipeline_tpu/ops/aug/
// pallas_shear.py:_shear_kernel (launched from shear_pass_tpu).  The TPU
// version keeps a tile of lines in VMEM and routes every line by its
// integer displacement with a log-shift: ceil(log2 N) static lane rolls,
// each kept per line by one bit of kmod.  The composition of those rolls is
// the direct index (q + kmod) mod N, which is what each thread computes
// here.
//
//   offs  = per-line displacement (B, L); kmod = floor(offs) mod N (floor
//           modulo, always >= 0), frac = offs - floor(offs)
//   out   = x[(q + kmod) mod N], nxt = x[(q + kmod + 1) mod N]
//   src   = (q + offs) - src_shift, the original-frame source coordinate
//   image : (1 - frac)*out + frac*nxt, then the edge clamps: src >= norig-1
//           takes out, src < 0 takes nxt
//   mask  : frac >= 0.5 ? nxt : out, with no edge clamps
//   both  : fill where src < -0.5 or src > norig - 0.5
//
// Bound on an H100: memory.  One launch writes the (B, C, L, N) f32 lines
// once and reads of each line only the columns its in-frame outputs use
// (at B16 C4 512 x 768: 100.7 MB written; about 67 MB read by the x-pass,
// whose frame is 512 of the 768, and up to 100.7 MB by the y-pass; 50-60 us
// at 3.35 TB/s); 9 flops per output.
//
// A thread per (plane, line, group of 4 consecutive outputs) on a 3-D grid
// (blockIdx.z = b*C + c, blockIdx.y = a tile of kLines lines, blockIdx.x =
// a chunk of 4 * kGroups outputs) with 32-bit index math: no thread divides
// a flat index.  A thread computes its line's offset, fraction and kmod
// once and walks up to kIters groups of the line.  The 4 outputs of a
// group read the 5 consecutive source values x[a0 .. a0 + 4] (mod N), five
// scalar loads that a warp's neighbouring threads share through L1, and
// are written with one 16-byte store where N % 4 == 0 and the output is
// aligned (four scalar stores otherwise).  The exact per-output test
// decides which outputs take fill; a group whose four outputs all do reads
// nothing, which spares the x-pass a third of its reads.
//
// What is left to the bound is the rate of the read-then-write stream
// itself: at 512 x 768 the y-pass takes 1.04 times a device copy of its
// lines, and with every kmod 0, so that each line's reads start aligned,
// the kernel is no faster (PERF.md §6).  Two aligned 16-byte loads a group
// in place of the five scalar ones, the lines staged in shared memory by
// 16-byte loads, 8 outputs a thread, streaming stores and other block
// shapes were all slower.
//
// The build passes -fmad=false so (q + offs) - src_shift and the blend
// round like the plain version and the JAX reference.  The redesign moved
// no f32 operation: the kernel equals the plain version bit for bit.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kLines = 4;                  // lines a block (blockDim.y)
constexpr int kThreads = 64;               // threads along a line
constexpr int kIters = 4;                  // groups of 4 a thread walks
constexpr int kGroups = kThreads * kIters;  // groups a block covers

// The output at original-frame coordinate src from its two taps
__device__ __forceinline__ float blend(float vo, float vn, float src,
                                       float frac, int norig, bool is_mask) {
  if (is_mask) return frac >= 0.5f ? vn : vo;
  float res = (1.0f - frac) * vo + frac * vn;
  if (src >= (float)norig - 1.0f) res = vo;
  if (src < 0.0f) res = vn;
  return res;
}

// x[a0 .. a0 + 4] (mod n) for a0 in [0, n), any n: each index is the last
// plus one, in [1, n], so one conditional subtract wraps it
__device__ __forceinline__ void load5(const float* line, int a0, int n,
                                      float v[5]) {
  int a = a0;
  v[0] = line[a];
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    a = wrap_once(a + 1, n);
    v[k] = line[a];
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads * kLines)
    shear_kernel(const float* __restrict__ x, const float* __restrict__ offs,
                 const int* __restrict__ kinds, float* __restrict__ out,
                 int nc, int nl, int n, int norig, int src_shift,
                 float fill) {
  int l = blockIdx.y * kLines + threadIdx.y;
  if (l >= nl) return;
  int p = blockIdx.z;
  int b = p / nc;
  int c = p - b * nc;
  bool is_mask = kinds[c] == 1;
  float o = offs[(size_t)b * nl + l];
  float kfloor = floorf(o);
  float frac = o - kfloor;
  // floor modulo: C++ % truncates toward zero, so shift a negative rest up
  int kmod = ((int)kfloor % n + n) % n;
  size_t base = ((size_t)p * nl + l) * n;
  const float* line = x + base;
  float* dst = out + base;
  int ng = (n + 3) / 4;
  int g0 = blockIdx.x * kGroups + threadIdx.x;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    int g = g0 + it * kThreads;
    if (g >= ng) break;
    int q0 = 4 * g;
    float src[4];
    bool in[4];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      src[j] = ((float)(q0 + j) + o) - (float)src_shift;
      in[j] = !(src[j] < -0.5f || src[j] > (float)norig - 0.5f) &&
              (kVec || q0 + j < n);
      any = any || in[j];
    }
    float res[4] = {fill, fill, fill, fill};
    if (any) {
      // q0 < n and kmod in [0, n): their sum wraps at most once
      int a0 = wrap_once(q0 + kmod, n);
      float v[5];
      load5(line, a0, n, v);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (in[j]) res[j] = blend(v[j], v[j + 1], src[j], frac, norig,
                                  is_mask);
    }
    if (kVec) {
      *reinterpret_cast<float4*>(dst + q0) =
          make_float4(res[0], res[1], res[2], res[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (q0 + j < n) dst[q0 + j] = res[j];
    }
  }
}

}  // namespace

extern "C" int stp_shear(const float* x, const float* offs, const int* kinds,
                         float* out, int nb, int nc, int nl, int n, int norig,
                         int src_shift, float fill, void* stream) {
  if ((long long)nb * nc * nl * n == 0) return (int)cudaGetLastError();
  int tiles = (nl + kLines - 1) / kLines;
  if (tiles > 65535 || (long long)nb * nc > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n + 4 * kGroups - 1) / (4 * kGroups), tiles, nb * nc);
  dim3 block(kThreads, kLines);
  cudaStream_t st = (cudaStream_t)stream;
  if (n % 4 == 0 && aligned16(out)) {
    shear_kernel<true><<<grid, block, 0, st>>>(x, offs, kinds, out, nc, nl,
                                               n, norig, src_shift, fill);
  } else {
    shear_kernel<false><<<grid, block, 0, st>>>(x, offs, kinds, out, nc, nl,
                                                n, norig, src_shift, fill);
  }
  return (int)cudaGetLastError();
}
