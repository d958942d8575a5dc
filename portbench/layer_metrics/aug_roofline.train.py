"""``aug_roofline.train``: the augmentation kernels' share of the geometric
block's roofline in a train step, in percent.

The least time: the block's float32 planes (3 image channels and 1 mask
channel, B × H × W each) read once and written once at 3.35e12 bytes/s.
Divided by the device time of the hand-written warp, elastic and shear
kernels named below.  A kernel renamed out of these fragments escapes the
metric.
"""

from portbench import common as C

FRAGMENTS = ("warp_x_kernel", "warp_y_kernel", "warp_ye_kernel",
             "elastic_kernel", "shear_kernel")
PLANES = 4


def read(t):
    tr = getattr(t, "trace", None)
    if tr is None:
        return None
    spent = tr.kernel_seconds(FRAGMENTS)
    if not spent:
        return None
    least = t.batch * t.size * t.size * PLANES * 4 * 2 / C.PEAK_HBM_BYTES
    return 100.0 * least * tr.units / spent
