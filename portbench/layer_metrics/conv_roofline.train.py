"""``conv_roofline.train``: the convolutions' share of their roofline in a
train step, in percent.

The least time: Σ over the model's convolutions (the logits head's matmul
too) and over the passes a step runs (forward, weight gradient, and the
input gradient wherever the input needs one) of max(FLOPs ÷ 989e12,
bytes ÷ 3.35e12), at the cell's batch, from the configuration's frozen
counts (each pass reads its two operands and writes its result once).
Divided by the device time of the kernels named below (cuDNN's dense,
grouped and depthwise convolutions and their layout transforms, CUTLASS,
cuBLAS and cuBLASLt ``nvjet`` GEMM and GEMV kernels).  A kernel
renamed out of these fragments escapes the metric.
"""

from portbench import common as C

FRAGMENTS = ("depthwise", "dwconv", "c1_k1_nhwc", "grouped_direct", "conv",
             "xmma", "gemm", "gemv", "cutlass", "sm90_", "winograd",
             "implicit", "nvjet", "tensortransform", "nhwctonchw",
             "nchwtonhwc")
EXCLUDE = ("elementwise", "vectorized", "reduce_kernel", "bn_", "warp_",
           "elastic_", "shear_", "multi_tensor")


def pass_seconds(row, b):
    flops, cin, cout, wts, _, _, width = row
    return max(flops * b / C.PEAK_BF16_FLOPS,
               ((cin + cout) * b + wts) * width / C.PEAK_HBM_BYTES)


def read(t):
    tr = getattr(t, "trace", None)
    if tr is None:
        return None
    spent = tr.kernel_seconds(FRAGMENTS, EXCLUDE)
    if not spent:
        return None
    least = sum(pass_seconds(row, t.batch) * (3 if row[5] else 2)
                for row in t.counts["conv"])
    return 100.0 * least * tr.units / spent
