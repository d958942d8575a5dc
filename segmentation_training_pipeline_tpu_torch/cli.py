"""Command-line entry points: ``fit`` / ``predict`` / ``evaluate``.

Counterpart of ``segmentation_training_pipeline_tpu/cli.py``:

    python -m segmentation_training_pipeline_tpu_torch predict cfg.yaml \
        src_dir dst_dir [--folds 0 1] [--stage -1] [--threshold 0.5]
    python -m segmentation_training_pipeline_tpu_torch evaluate cfg.yaml \
        --images data/images (--masks data/masks | --rle-csv labels.csv)
    python -m segmentation_training_pipeline_tpu_torch fit cfg.yaml \
        --images data/images (--masks data/masks | --rle-csv labels.csv) \
        [--folds 0 1] [--start-stage 0] [--timings epochs.json]

Each command runs on the card unless ``--device`` names another; ``fit``
prints its summary dict as JSON (and with ``--timings`` writes the
per-epoch timings of ``train/stage.py:fit_pipeline`` to a JSON file).
There is no compilation cache to set up (eager PyTorch).  Data-parallel
training runs one process per card under torchrun:

    torchrun --nproc-per-node 8 -m segmentation_training_pipeline_tpu_torch \
        fit cfg.yaml --images … --masks …

``parallel.distributed.maybe_initialize`` joins the processes (NCCL)
before any CUDA use when torchrun's environment or ``STP_DISTRIBUTED`` is
set; each process uses the card ``LOCAL_RANK``.
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_parser():
    p = argparse.ArgumentParser(prog="segmentation_training_pipeline_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fit", help="train all folds/stages per the YAML config")
    f.add_argument("config")
    f.add_argument("--images", required=True, help="images directory")
    f.add_argument("--masks", default=None, help="masks directory")
    f.add_argument("--rle-csv", default=None,
                   help="Kaggle-style CSV with id + RLE mask columns "
                        "(alternative to --masks)")
    f.add_argument("--folds", type=int, nargs="*", default=None)
    f.add_argument("--start-stage", type=int, default=0)
    f.add_argument("--device", default="cuda")
    f.add_argument("--timings", default=None,
                   help="write the per-epoch timings here (JSON)")

    pr = sub.add_parser("predict", help="predict masks for a directory")
    pr.add_argument("config")
    pr.add_argument("src")
    pr.add_argument("dst")
    pr.add_argument("--folds", type=int, nargs="*", default=None)
    pr.add_argument("--stage", type=int, default=-1)
    pr.add_argument("--threshold", type=float, default=None)
    pr.add_argument("--device", default="cuda")

    ev = sub.add_parser("evaluate", help="metrics over a labeled directory")
    ev.add_argument("config")
    ev.add_argument("--images", required=True)
    ev.add_argument("--masks", default=None)
    ev.add_argument("--rle-csv", default=None)
    ev.add_argument("--folds", type=int, nargs="*", default=None)
    ev.add_argument("--stage", type=int, default=-1)
    ev.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    # a torchrun launch: join the group before any CUDA use
    from .parallel import distributed as dist

    dist.maybe_initialize()
    from .config import parse
    from .data.datasets import CSVRLEDataSet, DirectoryDataSet

    def _dataset(a):
        if getattr(a, "rle_csv", None):
            if a.masks:
                raise SystemExit(
                    "--masks and --rle-csv are mutually exclusive label "
                    "sources — pass one")
            return CSVRLEDataSet(a.images, a.rle_csv)
        if not a.masks:
            raise SystemExit("need --masks or --rle-csv")
        return DirectoryDataSet(a.images, a.masks)

    cfg = parse(args.config)
    if args.cmd == "fit":
        ds = _dataset(args)
        timings = [] if args.timings else None
        res = cfg.fit(ds, foldsToExecute=args.folds,
                      start_from_stage=args.start_stage, device=args.device,
                      timings=timings)
        if timings is not None and dist.is_primary():
            with open(args.timings, "w") as f:
                json.dump(timings, f)
        print(json.dumps(res, indent=2, default=str))
    elif args.cmd == "predict":
        n = cfg.predict_all_to_dir(args.src, args.dst, folds=args.folds,
                                   stage=args.stage, threshold=args.threshold,
                                   device=args.device)
        print(f"wrote {n} masks to {args.dst}")
    elif args.cmd == "evaluate":
        ds = _dataset(args)
        res = cfg.evaluate(ds, folds=args.folds, stage=args.stage,
                           device=args.device)
        print(json.dumps(res, indent=2))
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
