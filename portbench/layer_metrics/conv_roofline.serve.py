"""``conv_roofline.serve``: the convolutions' share of their roofline in a
serving call, in percent.

The least time: Σ over the model's convolutions (the logits head's matmul
too) of max(FLOPs ÷ 989e12, bytes ÷ 3.35e12) of the forward pass at the
cell's batch, from the configuration's frozen counts, times the forwards a
call runs (folds × 2 flip views).  Divided by the device time of the
kernels named below (cuDNN's dense, grouped and depthwise convolutions
and their layout transforms, CUTLASS, cuBLAS and cuBLASLt ``nvjet`` GEMM
and GEMV kernels).  A kernel renamed out of these fragments
escapes the metric.
"""

from portbench import common as C

FRAGMENTS = ("depthwise", "dwconv", "c1_k1_nhwc", "grouped_direct", "conv",
             "xmma", "gemm", "gemv", "cutlass", "sm90_", "winograd",
             "implicit", "nvjet", "tensortransform", "nhwctonchw",
             "nchwtonhwc")
EXCLUDE = ("elementwise", "vectorized", "reduce_kernel", "bn_", "warp_",
           "elastic_", "shear_", "multi_tensor")


def read(t):
    tr = getattr(t, "trace", None)
    if tr is None:
        return None
    spent = tr.kernel_seconds(FRAGMENTS, EXCLUDE)
    if not spent:
        return None
    b = t.batch
    least = sum(max(f * b / C.PEAK_BF16_FLOPS,
                    ((cin + cout) * b + w) * width / C.PEAK_HBM_BYTES)
                for f, cin, cout, w, _, _, width in t.counts["conv"])
    forwards = t.workload["folds"] * 2
    return 100.0 * least * forwards * tr.units / spent
