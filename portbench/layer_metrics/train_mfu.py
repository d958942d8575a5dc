"""``train_mfu``: the whole training step's share of the card's bf16 peak.

Training FLOPs per image (3 × the forward's convolution and matmul FLOPs,
frozen in the configuration file; no recompute counted) × the images per
second of the traced run's unprofiled window ÷ 989e12 (H100 SXM dense
bf16), in percent.
"""

from portbench import common as C

def read(t):
    img_s = getattr(t, "img_per_s", None)
    if not img_s:
        return None
    return 100.0 * t.counts["train_flops"] * img_s / C.PEAK_BF16_FLOPS
