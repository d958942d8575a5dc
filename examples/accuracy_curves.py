"""Per-epoch curves of two or more fits side by side, from their metrics
CSVs (the ``metrics-{fold}.{stage}.csv`` files that both packages' fits
write, or the copies under ``docs/evidence/``):

    python examples/accuracy_curves.py --also loss \\
        JAX=docs/evidence/jax_cpu/shared_init/config1_f0s0_metrics.csv \\
        port=docs/evidence/torch/shared_init/seed33/config1_metrics-0.0.csv

prints a markdown table with one row per epoch, each fit's ``val_iou``
(and the column ``--also`` names, e.g. ``loss``), then the best val_iou
of each and the first epoch at which the fits' val_iou differ by more
than PART.
"""

from __future__ import annotations

import argparse
import csv

COLUMN = "val_iou"
PART = 0.01     # a val_iou difference that counts as parted


def read(path: str):
    with open(path) as f:
        return list(csv.DictReader(f))


def main(argv=None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("fits", nargs="+", metavar="NAME=CSV")
    p.add_argument("--also", default=None)
    a = p.parse_args(argv)
    fits = [(f.split("=", 1)[0], read(f.split("=", 1)[1])) for f in a.fits]
    cols = [COLUMN] + ([a.also] if a.also else [])
    head = ["epoch"] + [f"{n} {c}" for c in cols for n, _ in fits]
    lines = ["| " + " | ".join(head) + " |",
             "|" + "---|" * len(head)]
    parted = None
    for e in range(max(len(rows) for _, rows in fits)):
        vals = [rows[e][c] if e < len(rows) else ""
                for c in cols for _, rows in fits]
        lines.append(f"| {e} | " + " | ".join(vals) + " |")
        main_vals = [float(rows[e][COLUMN]) for _, rows in fits
                     if e < len(rows)]
        if parted is None and len(main_vals) == len(fits) and \
                max(main_vals) - min(main_vals) > PART:
            parted = e
    best = [max(float(r[COLUMN]) for r in rows) for _, rows in fits]
    lines.append("| best | " + " | ".join(f"{b:.6f}" for b in best)
                 + " |" + " |" * (len(head) - 1 - len(best)))
    lines.append(f"\nfirst epoch parted by more than {PART}: {parted}")
    out = "\n".join(lines)
    print(out)
    return out


if __name__ == "__main__":
    main()
