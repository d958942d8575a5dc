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
_F = ctypes.c_float


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "csrc/ with the CUDA toolkit at first use")
    return path


def _library_path(source: str) -> Path:
    text = (CSRC_DIR / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
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


class Kernel:
    """One CUDA entry point with a plain C interface returning
    ``cudaGetLastError()`` after its launch."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source          # file under csrc/
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces      # the TPU kernel, file:line
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
    )
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer value."""
    return torch.cuda.current_stream(t.device).cuda_stream


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
