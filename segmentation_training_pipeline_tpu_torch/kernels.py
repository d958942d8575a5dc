"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper (``sm_90a``) into
its own shared library with a plain C interface under ``_build/`` (git
ignores it), at first use, and bound with ``ctypes``.  Library names carry
a hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded.  All sources build in parallel, one ``nvcc``
each.

Every kernel entry point is a :class:`Kernel` in :data:`KERNELS`.  Its
``launches`` count goes up by one each time its wrapper launches it, and
nowhere else, so a run can show that its main path went through the
kernel (``reset_launches`` / ``launch_counts``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# -fmad=false: no multiply-add contraction, so the coordinate arithmetic
# rounds exactly like the plain PyTorch versions and the JAX reference
# (an FMA can move a coordinate across a .5 tie and flip a mask pixel)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ with the CUDA toolkit at first use")
    return path


def _library_path(source: str) -> Path:
    # the headers every source may include count as part of each source
    text = b"".join(p.read_bytes() for p in [CSRC_DIR / source,
                                              *sorted(CSRC_DIR.glob("*.cuh"))])
    text += " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:12]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


_build_lock = threading.Lock()
_libraries: Dict[str, ctypes.CDLL] = {}


def build(sources: Optional[Iterable[str]] = None) -> List[Path]:
    """Compile every source not yet built (all ``nvcc`` runs in parallel)
    and return the library paths.  Raises with the compiler's output when
    a build fails."""
    sources = sorted({k.source for k in KERNELS.values()}
                     if sources is None else set(sources))
    with _build_lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo = [s for s in sources if not _library_path(s).exists()]
        if todo:
            nvcc = find_nvcc()
            procs = []
            for s in todo:
                out = _library_path(s)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / s)]
                procs.append((s, out, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            failures = []
            for s, out, tmp, p in procs:
                log, _ = p.communicate()
                if p.returncode != 0:
                    failures.append(f"{s}:\n{log.decode(errors='replace')}")
                else:
                    os.replace(tmp, out)
            if failures:
                raise RuntimeError("nvcc failed for " + "\n".join(failures))
        return [_library_path(s) for s in sources]


def _library(source: str) -> ctypes.CDLL:
    lib = _libraries.get(source)
    if lib is None:
        path = build([source])[0]
        lib = ctypes.CDLL(str(path))
        _libraries[source] = lib
    return lib


def function(source: str, symbol: str, argtypes: Sequence):
    """A C function of ``source``'s library that launches nothing (a
    query), returning an ``int``."""
    fn = getattr(_library(source), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


class Kernel:
    """One CUDA entry point with a plain C interface returning
    ``cudaGetLastError()`` after its launch."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source          # file under csrc/
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces      # the TPU kernel, file:line, or none
        self.launches = 0
        self._fn = None

    def launch(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        self.launches += 1


_PLANE_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]
# a batch-norm launch's geometry (models/batchnorm.py:_plan): rows, outer,
# inner, span, channels, slices, tile width, mode (one value at a time, the
# ring of bulk copies or direct 16-byte loads), cluster, items
BN_GEO = [_I, _L, _L, _L, _I, _I, _I, _I, _I, _I]
BN_REPLACES = "none: flax nn.BatchNorm, XLA-lowered"

KERNELS: Dict[str, Kernel] = {
    k.name: k for k in (
        Kernel("warp_x", "warp_xy.cu", "stp_warp_x", _PLANE_ARGS,
               "segmentation_training_pipeline_tpu/ops/aug/pallas_warp.py:279"),
        Kernel("warp_y", "warp_xy.cu", "stp_warp_y", _PLANE_ARGS,
               "segmentation_training_pipeline_tpu/ops/aug/pallas_warp.py:296"),
        Kernel("elastic", "elastic.cu", "stp_elastic",
               [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
               "segmentation_training_pipeline_tpu/ops/aug/"
               "pallas_elastic.py:155"),
        Kernel("shear", "shear.cu", "stp_shear",
               [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
               "segmentation_training_pipeline_tpu/ops/aug/"
               "pallas_shear.py:98"),
        Kernel("warp_ye", "warp_xy.cu", "stp_warp_ye",
               [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
               "segmentation_training_pipeline_tpu/ops/aug/"
               "pallas_warp.py:312"),
        Kernel("bn_stats", "batchnorm.cu", "stp_bn_stats",
               [_P, _I, *BN_GEO, _P, _P, _P, _P], BN_REPLACES),
        Kernel("bn_apply", "batchnorm.cu", "stp_bn_apply",
               [_P, _P, _I, *BN_GEO, _P, _P, _P, _P, _P, _D, _D, _P, _P,
                _P, _P, _P], BN_REPLACES),
        Kernel("bn_grad_stats", "batchnorm.cu", "stp_bn_grad_stats",
               [_P, _P, _I, *BN_GEO, _P, _P, _P, _P, _P, _P, _P, _P],
               BN_REPLACES),
        Kernel("bn_grad_apply", "batchnorm.cu", "stp_bn_grad_apply",
               [_P, _P, _P, _I, *BN_GEO, _P, _P, _P, _P, _P, _P],
               BN_REPLACES),
    )
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer value (the
    raw query: ``torch.cuda.current_stream`` builds a ``Stream`` object
    each call, the larger part of a small launch's host time)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


# the shared memory one block may take on the H100, in bytes, and the
# largest count of blocks along a grid's y or z axis
SMEM_BYTES = 232448
GRID_AXIS = 65535


def check_block(kernel: str, planes: torch.Tensor, smem: int,
                on_z: int) -> None:
    """A kernel that takes ``smem`` bytes of shared memory a block, one
    block per row or tile of rows along the grid's y axis (at most H) and
    ``on_z`` along its z axis; refuse what one block or one axis cannot
    take."""
    h, w = planes.shape[2:]
    if smem > SMEM_BYTES:
        raise ValueError(f"{kernel}: a row of width {w} needs {smem} bytes "
                         f"of shared memory, more than the {SMEM_BYTES} a "
                         f"block may take")
    if on_z > GRID_AXIS or h > GRID_AXIS:
        raise ValueError(f"{kernel}: {on_z} blocks or {h} rows exceed a "
                         f"grid axis of {GRID_AXIS}")


def check_plane_args(kernel: str, planes: torch.Tensor,
                     per_channel: torch.Tensor,
                     extra: Sequence[torch.Tensor] = ()) -> None:
    """Validate the tensors a plane kernel reads: all on one CUDA device,
    contiguous, f32 planes (B, C, H, W), i32 per-channel flags (C,)."""
    ts = [planes, per_channel, *extra]
    dev = planes.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: CUDA kernel needs CUDA tensors, got "
                         f"{dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{kernel}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: inputs must be contiguous")
    if planes.dtype != torch.float32 or planes.dim() != 4:
        raise ValueError(f"{kernel}: planes must be (B, C, H, W) float32, "
                         f"got {tuple(planes.shape)} {planes.dtype}")
    if per_channel.dtype != torch.int32 or per_channel.shape != (
            planes.shape[1],):
        raise ValueError(f"{kernel}: per-channel flags must be ({planes.shape[1]},)"
                         f" int32, got {tuple(per_channel.shape)} "
                         f"{per_channel.dtype}")
