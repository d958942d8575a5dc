"""``serve_mfu``: the whole serving call's share of the card's bf16 peak.

Forward FLOPs per image (frozen in the configuration file) × the forwards
each served image takes (folds × 2 flip views) × the images per second of
the traced run's unprofiled window ÷ 989e12 (H100 SXM dense bf16), in
percent.
"""

from portbench import common as C

def read(t):
    img_s = getattr(t, "img_per_s", None)
    if not img_s:
        return None
    per_image = t.counts["forward_flops"] * t.workload["folds"] * 2
    return 100.0 * per_image * img_s / C.PEAK_BF16_FLOPS
