"""PyTorch/CUDA port of segmentation_training_pipeline_tpu for NVIDIA Hopper.

The JAX package beside this one is the reference; this package imports
``torch`` and never ``jax`` or anything of the JAX package.  The TPU's
Pallas kernels on the ported path are CUDA C++ kernels under ``csrc/``,
built with ``nvcc`` at first use (``kernels.py``).  Entry points run on
the card (``device="cuda"``) unless the caller passes another device.
"""

__version__ = "0.1.0"
