"""``bn_roofline.train``: batch norm's share of its roofline in a train
step, in percent.

The least time counts the layer's work, not each kernel's reads: per
BatchNorm layer, forward reads x and writes y, backward reads x and dy and
writes dx, five passes over the layer's map at the activation type's 2
bytes, at 3.35e12 bytes/s (elements per image frozen in the configuration
file).  Divided by the device time of the batch-norm kernels named below
(the program's ``bn_stats``, ``bn_apply``, ``bn_grad_stats``,
``bn_grad_apply``, and any library batch norm).  A kernel renamed out of
these fragments escapes the metric.
"""

from portbench import common as C

FRAGMENTS = ("bn_", "batch_norm", "batchnorm", "welford")


def read(t):
    tr = getattr(t, "trace", None)
    if tr is None:
        return None
    spent = tr.kernel_seconds(FRAGMENTS)
    if not spent:
        return None
    least = sum(t.counts["bn"]) * t.batch * 5 * 2 / C.PEAK_HBM_BYTES
    return 100.0 * least * tr.units / spent
