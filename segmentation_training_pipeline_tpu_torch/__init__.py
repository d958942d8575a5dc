"""PyTorch/CUDA port of segmentation_training_pipeline_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
``torch`` and never ``jax`` or anything of the JAX package.  The TPU's
Pallas kernels on the ported path are CUDA C++ kernels under ``csrc/``,
built with ``nvcc`` at first use (``kernels.py``).  Entry points run on
the card (``device="cuda"``) unless the caller passes another device.

The public surface is the reference's::

    import segmentation_training_pipeline_tpu_torch as segmentation
    cfg = segmentation.parse("config.yaml")
    cfg.fit(dataset)                     # K-fold, multi-stage training
    cfg.predict_all_to_dir(src, dst)     # flip-TTA + fold-ensemble inference
"""

__version__ = "0.1.0"

from .config import PipelineConfig, Stage, parse, parse_dict
from .data.datasets import (
    PredictionItem,
    DataSet,
    CompositeDataSet,
    CSVRLEDataSet,
    SubDataSet,
    KFoldedDataSet,
    DirectoryDataSet,
)
from .ops import losses, metrics

__all__ = [
    "PipelineConfig",
    "Stage",
    "parse",
    "parse_dict",
    "PredictionItem",
    "DataSet",
    "CompositeDataSet",
    "CSVRLEDataSet",
    "SubDataSet",
    "KFoldedDataSet",
    "DirectoryDataSet",
    "losses",
    "metrics",
    "__version__",
]
