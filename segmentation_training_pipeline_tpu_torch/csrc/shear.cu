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
// here: one thread per output element, two reads from its line.
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
// Bound on an H100: memory.  One launch reads the (B, C, L, N) f32 lines
// once and writes them once (at B16 C4 512 x 768: 25 MiB + 25 MiB, about
// 15 us at 3.35 TB/s); ~15 flops per element.  Threads of a warp run along
// N, so the two reads of a thread are coalesced with its neighbours' and
// the second is an L1 hit.
//
// The build passes -fmad=false so (q + offs) - src_shift and the blend
// round like the plain version and the JAX reference.

#include <cuda_runtime.h>

namespace {

__global__ void shear_kernel(const float* __restrict__ x,
                             const float* __restrict__ offs,
                             const int* __restrict__ kinds,
                             float* __restrict__ out, int nb, int nc, int nl,
                             int n, int norig, int src_shift, float fill) {
  long long total = (long long)nb * nc * nl * n;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  int q = (int)(idx % n);
  int l = (int)((idx / n) % nl);
  int c = (int)((idx / ((long long)n * nl)) % nc);
  int b = (int)(idx / ((long long)n * nl * nc));

  float o = offs[(long long)b * nl + l];
  float src = ((float)q + o) - (float)src_shift;
  if (src < -0.5f || src > (float)norig - 0.5f) {
    out[idx] = fill;
    return;
  }
  float kfloor = floorf(o);
  float frac = o - kfloor;
  // floor modulo: C++ % truncates toward zero, so shift a negative rest up
  int kmod = ((int)kfloor % n + n) % n;
  int a = (q + kmod) % n;
  int a1 = a + 1 == n ? 0 : a + 1;
  const float* line = x + (((long long)b * nc + c) * nl + l) * n;
  float vo = line[a];
  float vn = line[a1];
  float res;
  if (kinds[c] == 1) {
    res = frac >= 0.5f ? vn : vo;
  } else {
    res = (1.0f - frac) * vo + frac * vn;
    if (src >= (float)norig - 1.0f) res = vo;
    if (src < 0.0f) res = vn;
  }
  out[idx] = res;
}

constexpr int kThreads = 256;

}  // namespace

extern "C" int stp_shear(const float* x, const float* offs, const int* kinds,
                         float* out, int nb, int nc, int nl, int n, int norig,
                         int src_shift, float fill, void* stream) {
  long long total = (long long)nb * nc * nl * n;
  if (total > 0) {
    unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
    shear_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        x, offs, kinds, out, nb, nc, nl, n, norig, src_shift, fill);
  }
  return (int)cudaGetLastError();
}
