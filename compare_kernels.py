#!/usr/bin/env python3
"""Time versions of the port's CUDA kernels side by side on one card.

    python3 compare_kernels.py SOURCE[:ABLATION] [SOURCE[:ABLATION] ...]

A SOURCE is either a version of a file in
``segmentation_training_pipeline_tpu_torch/csrc/`` (an older commit's, or
an edit of it), whose kernel entry points stand in for the port's own
while each kernel runs through this tree's wrapper, or the root of a
checkout of this repository (``git archive`` of a commit, unpacked under
the git-ignored ``_versions/``), whose ``csrc/batchnorm.cu`` runs through
that checkout's own wrappers and launch plan: its package is copied under
another name and imported beside this one.  Each is built with the
port's ``nvcc`` flags plus ``-Xptxas -v`` (the register counts are
printed).  A version that disagrees with the plain versions is reported,
not refused.  The versions run in turns, first to last and back (A B … B
A), so that versions are compared within one call on one card.

The warp, elastic and shear kernels run on the tensors ``chip_smoke.py``
captures at the train shapes, one JSON line per version and kernel; the
shear's rows also give the time and the bound of each of its two passes
(``pass_ms``, ``pass_bound_ms``).  The first two lines time one device
copy (``copy_``, the same bytes read and written once) of the planes
kernels X and Y take and of the lines the shear's x-pass takes.

The batch-norm kernels (a version of ``batchnorm.cu``) run on every case
of ``chip_smoke.py``'s ``batchnorm`` phase (``BN_CASES``) as the phase
runs them (each kernel's launches, then its plain version and its
PyTorch call, so that every kernel finds the card as it does there), one
JSON line per version and case with each kernel's ms, bound share, plain
and library ms and checks (``ok``: sums within 1e-12, derived outputs 0
ulp, two launches bit for bit), the streaming yardsticks ``y.copy_(x)``
(``bn_apply``'s bytes) and ``torch.add(dy, x, out=dx)``
(``bn_grad_apply``'s), and per version and turn the step-weighted totals
of the train step's seven maps.  One line per version gives, for each of
its ``bn_*`` kernel instantiations, the registers, static shared memory
and resident blocks per SM that libcuda's
``cuOccupancyMaxActiveBlocksPerMultiprocessor`` allows at its launch
bound (a ``-cubin`` build of the same source, loaded with ``libcuda``).

``:ABLATION`` builds the version with a deliberate fault, a macro that
``batchnorm.cu`` defines (``STP_BN_ABLATE_*``, passed with ``-D``), to
split a kernel's time: ``one_level`` (a cluster's first block finishes
its cluster's sums: no partials, ticket or tail), ``no_cluster`` (each
block finishes its own sums), ``const_coef`` (``bn_apply`` and
``bn_grad_apply`` take constant coefficients instead of computing them),
``empty`` (the reductions and ``bn_grad_apply`` return at once: the
launch alone).  Their outputs are wrong and reported so.  Needs one CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

import torch

import chip_smoke as CS
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.models import batchnorm as BN

FIELDS = ("ms", "plain_ms", "bound_ms", "bound_share", "max_abs_err",
          "mask_mismatch")
PACKAGE = "segmentation_training_pipeline_tpu_torch"

# deliberate faults: macros that batchnorm.cu defines
MACROS = {"one_level": "STP_BN_ABLATE_ONE_LEVEL",
          "no_cluster": "STP_BN_ABLATE_NO_CLUSTER",
          "empty": "STP_BN_ABLATE_EMPTY",
          "const_coef": "STP_BN_ABLATE_CONST_COEF"}


class Version(NamedTuple):
    """One SOURCE: its label, the ``.cu`` file built, and the port's
    ``kernels`` and ``models.batchnorm`` modules its launches go through
    (this tree's for a bare file, the checkout's own for a root)."""
    spec: str
    source: Path
    K: ModuleType
    BN: ModuleType


def version(spec: str, i: int, pkgs: Path) -> Version:
    """``spec`` (``PATH[:ABLATION]``) resolved: a directory is the root of
    a checkout, whose package is copied under ``pkgs`` as
    ``stp_version{i}`` and imported under that name."""
    path = Path(spec.partition(":")[0])
    if not path.is_dir():
        return Version(spec, path, K, BN)
    name = f"stp_version{i}"
    shutil.copytree(path / PACKAGE, pkgs / name,
                    ignore=shutil.ignore_patterns("_build", "*.so"))
    if str(pkgs) not in sys.path:
        sys.path.insert(0, str(pkgs))
    return Version(spec, path / PACKAGE / "csrc" / "batchnorm.cu",
                   importlib.import_module(name + ".kernels"),
                   importlib.import_module(name + ".models.batchnorm"))


def demangle(names: list[str]) -> list[str]:
    tool = shutil.which("c++filt")
    if tool is None:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def occupancy(cubin: Path, names: list[str]) -> list[dict]:
    """Registers, static shared memory and resident blocks per SM of each
    kernel of ``cubin`` at its launch bound, from libcuda."""
    cu = ctypes.CDLL("libcuda.so.1")
    torch.zeros(1, device="cuda")        # the primary context, current
    mod = ctypes.c_void_p()
    if cu.cuModuleLoad(ctypes.byref(mod), str(cubin).encode()) != 0:
        raise RuntimeError(f"cuModuleLoad failed for {cubin}")
    out = []
    for name, pretty in zip(names, demangle(names)):
        f = ctypes.c_void_p()
        if cu.cuModuleGetFunction(ctypes.byref(f), mod, name.encode()) != 0:
            continue

        def attr(a: int) -> int:
            v = ctypes.c_int()
            cu.cuFuncGetAttribute(ctypes.byref(v), a, f)
            return v.value
        # CU_FUNC_ATTRIBUTE_: 0 max threads a block, 1 static shared
        # bytes, 4 registers
        threads, smem, regs = attr(0), attr(1), attr(4)
        n = ctypes.c_int()
        cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(ctypes.byref(n), f,
                                                       threads, 0)
        out.append(dict(kernel=pretty, threads=threads, registers=regs,
                        static_smem=smem, blocks_per_sm=n.value))
    cu.cuModuleUnload(mod)
    return out


def build(versions: list[Version]) -> list[ctypes.CDLL]:
    """Compile every version in parallel into ``_build/compare/``: the
    shared library and, for a ``batchnorm.cu`` version, a cubin for the
    occupancy line.  ``:ABLATION`` adds its macro."""
    out_dir = K.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = K.find_nvcc()
    cubin_flags = [f for f in K.NVCC_FLAGS
                   if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = []
    for i, v in enumerate(versions):
        ablation = v.spec.partition(":")[2]
        inc = ["-I", str(v.source.parent)]
        if ablation:
            inc.append(f"-D{MACROS[ablation]}")
        lib = out_dir / f"{i}-{v.source.stem}.so"
        cubin = out_dir / f"{i}-{v.source.stem}.cubin"
        procs.append((v.spec, lib, cubin, subprocess.Popen(
            [nvcc, *K.NVCC_FLAGS, "-Xptxas", "-v", *inc, "-o", str(lib),
             str(v.source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT),
            subprocess.Popen([nvcc, *cubin_flags, "-cubin", *inc, "-o",
                              str(cubin), str(v.source)],
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT)))
    # every build to its end before any is read, so a failure leaves none
    logs = [(p.communicate()[0].decode(errors="replace"), pc.communicate())
            for *_, p, pc in procs]
    libs = []
    for (spec, lib, cubin, p, pc), (log, _) in zip(procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {spec}:\n{log}")
        print(json.dumps({"build": spec, "ptxas": [
            line.split(":", 1)[-1].strip() for line in log.splitlines()
            if "Compiling entry" in line or "registers" in line
            or "spill" in line]}),
            flush=True)
        entries = [line.split("'")[1] for line in log.splitlines()
                   if "Compiling entry" in line and "'" in line]
        bn = [e for e in entries if "bn_" in e]
        if bn and pc.returncode == 0:
            print(json.dumps({"occupancy": spec,
                              "kernels": occupancy(cubin, bn)}), flush=True)
        libs.append(ctypes.CDLL(str(lib)))
    return libs


def entry_points(lib: ctypes.CDLL, kernels: ModuleType) -> dict:
    """The port's kernels that ``lib`` exports, with the C signatures of
    ``kernels`` (the version's ``kernels`` module), and its occupancy
    query where it has one."""
    fns = {}
    for k in kernels.KERNELS.values():
        if hasattr(lib, k.symbol):
            fn = getattr(lib, k.symbol)
            fn.argtypes = k.argtypes
            fn.restype = ctypes.c_int
            fns[k.name] = fn
    if hasattr(lib, "stp_bn_occupancy"):
        fn = lib.stp_bn_occupancy
        fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
        fns["occupancy"] = fn
    return fns


def bn_turn(v: Version, fns: dict) -> None:
    """The batch-norm kernels of one version through its wrappers and
    launch plan on every ``BN_CASES`` case, and the step-weighted
    totals."""
    kernels, bn = v.K, v.BN
    saved = {n: kernels.KERNELS[n]._fn for n in CS.BN_KERNELS}
    occupancy_fn, chip_bn = bn._occupancy, CS.BN
    bn._GEOMETRY.clear()
    bn._CARDS.clear()
    try:
        for n in CS.BN_KERNELS:
            kernels.KERNELS[n]._fn = fns[n]
        if "occupancy" in fns:
            bn._occupancy = lambda: fns["occupancy"]
        CS.BN = bn
        cases = [CS._bn_case(name, shape, dtype, layout, CS.SEED + i,
                             strict=False)
                 for i, (name, shape, dtype, layout)
                 in enumerate(CS.BN_CASES)]
    finally:
        for n in CS.BN_KERNELS:
            kernels.KERNELS[n]._fn = saved[n]
        bn._occupancy, CS.BN = occupancy_fn, chip_bn
        bn._GEOMETRY.clear()
        bn._CARDS.clear()
    for c in cases:
        print(json.dumps({"source": v.spec, "case": c["case"],
                          "shape": c["shape"], "dtype": c["dtype"],
                          "layout": c["layout"], "ok": c["ok"],
                          "kernels": {k: {f: r.get(f) for f in (
                              "ms", "bound_ms", "bound_share", "plain_ms",
                              "library_ms", "copy_ms", "add_ms", "sum_rel",
                              "ulps", "bit_identical_launches")}
                              for k, r in c["kernels"].items()}}),
              flush=True)
    totals = CS.bn_step_totals(cases)
    print(json.dumps({"source": v.spec, "step_totals_ms": {
        k: t["ms"] for k, t in totals.items()}, "step_bound_ms": {
        k: t["bound_ms"] for k, t in totals.items()}}), flush=True)


def run(versions: list[Version], fns_of: list[dict]) -> None:
    """The aug kernels' yardsticks, then every version's kernels in
    turns."""
    aug = any(n in CS.CALLS for fns in fns_of for n in fns)
    if aug:
        args_of = CS.phase_capture(*CS.train_shapes())
        # kernel Y's planes and the shear's x-pass lines
        for planes in (args_of["warp_y"][0], args_of["shear"][0][0]):
            copy = torch.empty_like(planes)
            print(json.dumps({"yardstick": "copy_",
                              "shape": list(planes.shape),
                              "bytes": 2 * planes.numel()
                              * planes.element_size(),
                              "ms": CS.cuda_ms(lambda: copy.copy_(planes),
                                               50, hold=True)}), flush=True)
    turns = list(range(len(versions)))
    for i in turns + turns[::-1]:
        v, fns = versions[i], fns_of[i]
        for name, fn in fns.items():
            if name not in CS.CALLS:
                continue
            kernel = K.KERNELS[name]
            saved, kernel._fn = kernel._fn, fn
            try:
                m = CS.measure_kernel(name, args_of)
            finally:
                kernel._fn = saved
            row = {"source": v.spec, "kernel": name,
                   **{f: m[f] for f in FIELDS}}
            if "passes" in m:
                row["pass_ms"] = [p["ms"] for p in m["passes"]]
                row["pass_bound_ms"] = [p["bound_ms"] for p in m["passes"]]
            print(json.dumps(row), flush=True)
        if all(n in fns for n in CS.BN_KERNELS):  # a batchnorm.cu version
            bn_turn(v, fns)


def main(argv=None) -> int:
    specs = sys.argv[1:] if argv is None else argv
    if not specs:
        print(__doc__, file=sys.stderr)
        return 2
    CS.phase_device()
    # the checkouts' packages stay importable for the whole run
    with tempfile.TemporaryDirectory() as tmp:
        versions = [version(spec, i, Path(tmp))
                    for i, spec in enumerate(specs)]
        fns_of = [entry_points(lib, v.K)
                  for lib, v in zip(build(versions), versions)]
        run(versions, fns_of)
    return 0


if __name__ == "__main__":
    sys.exit(main())
