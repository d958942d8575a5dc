#!/usr/bin/env python3
"""Time versions of the port's CUDA kernels side by side on one card.

    python3 compare_kernels.py SOURCE.cu[:ABLATION] [SOURCE.cu[:ABLATION] ...]

Each SOURCE is a version of a file in
``segmentation_training_pipeline_tpu_torch/csrc/``: an older commit's, or
an edit of it.  It is built with the port's ``nvcc`` flags plus
``-Xptxas -v`` (the register counts are printed), and each kernel entry
point it exports stands in for the port's own while that kernel runs
through its wrapper.  A version that disagrees with the plain versions is
reported, not refused.  The versions run in turns, first to last and back
(A B … B A), so that versions are compared within one call on one card.

The warp, elastic and shear kernels run on the tensors ``chip_smoke.py``
captures at the train shapes, one JSON line per version and kernel; the
shear's rows also give the time and the bound of each of its two passes
(``pass_ms``, ``pass_bound_ms``).  The first two lines time one device
copy (``copy_``, the same bytes read and written once) of the planes
kernels X and Y take and of the lines the shear's x-pass takes.

The batch-norm kernels (a version of ``batchnorm.cu``) run on every case
of ``chip_smoke.py``'s ``batchnorm`` phase (``BN_CASES``), one JSON line
per version and case with each kernel's ms, bound share and checks
(``ok``: sums within 1e-12, derived outputs 0 ulp, two launches bit for
bit), and per version and turn the step-weighted totals of the train
step's seven maps.  Before the turns, one line per case times
``y.copy_(x)`` (``bn_apply``'s bytes) and one line per version gives, for
each of its ``bn_*`` kernel instantiations, the registers, static shared
memory and resident blocks per SM that libcuda's
``cuOccupancyMaxActiveBlocksPerMultiprocessor`` allows at its launch
bound (a ``-cubin`` build of the same source, loaded with ``libcuda``).
A source that exports no ``stp_bn_occupancy`` takes the launch geometry
of the first design (``batchnorm.cu`` at commit 419b04d: one plan for the
four kernels, four 256-thread blocks an SM aimed at), so that it runs
through today's wrappers.

``:ABLATION`` builds the source with a deliberate fault, to split a
kernel's time.  Today's source defines them (``STP_BN_ABLATE_*`` in
``batchnorm.cu``, passed with ``-D``): ``one_level`` (a cluster's first
block finishes its cluster's sums: no partials, ticket or tail),
``no_cluster`` (each block finishes its own sums), ``empty`` (the
reductions return at once: the launch alone).  The first design's
(``batchnorm.cu`` at commit 419b04d) are replacements of its text, each
of which must match it: ``no_tail`` (the reductions' block 0 finishes
alone: no ticket, no fence, no tail over the partials), ``f32_sums`` (the
reductions accumulate in float32), ``const_coef`` (``bn_apply`` takes
constant coefficients instead of computing them).  Their sums are wrong
and reported so.  Needs one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as CS
from segmentation_training_pipeline_tpu_torch import kernels as K
from segmentation_training_pipeline_tpu_torch.models import batchnorm as BN

FIELDS = ("ms", "plain_ms", "bound_ms", "bound_share", "max_abs_err",
          "mask_mismatch")

# the first design's deliberate faults, as (old, new) replacements of its
# text (batchnorm.cu at commit 419b04d)
ABLATIONS = {
    "no_tail": [
        ("    if (!last_arrival(tickets + c, g.slices)) return;",
         "    if (s != 0) return;"),
        ("    if (!last_arrival(tickets + t, g.slices)) return;",
         "    if (s != 0) return;"),
        ("                                        double& sb) {\n"
         "  constexpr int kMlp = 8;",
         "                                        double& sb) {\n"
         "  if (n > 0) return;\n  constexpr int kMlp = 8;"),
    ],
    "f32_sums": [
        ("                                           double* a, double* b) {",
         "                                           float* a, float* b) {"),
        ("      double gd = (double)dv[k];", "      float gd = (float)dv[k];"),
        ("      b[kPerValue ? k : 0] += gd * (double)d;",
         "      b[kPerValue ? k : 0] += gd * (float)d;"),
        ("      double d = (double)xv[k];", "      float d = (float)xv[k];"),
        ("    double a[1] = {0.0}, b[1] = {0.0};",
         "    float a[1] = {0.f}, b[1] = {0.f};"),
        ("    block_sum2(a[0], b[0]);\n    if (threadIdx.x == 0) {\n"
         "      partials[(long long)c * S + s] = a[0];\n"
         "      partials[((long long)g.nc + c) * S + s] = b[0];",
         "    double a0 = a[0], b0 = b[0];\n    block_sum2(a0, b0);\n"
         "    if (threadIdx.x == 0) {\n"
         "      partials[(long long)c * S + s] = a0;\n"
         "      partials[((long long)g.nc + c) * S + s] = b0;"),
        ("    double a[V], b[V];", "    float a[V], b[V];"),
    ],
    "const_coef": [
        ("    const Fwd<A> k = forward_coef<A>(sums, g.nc, c, eps, w, b);",
         "    const Fwd<A> k = {A(0), A(1), A(1), A(1), A(0)};"),
        ("      k[q] = forward_coef<A>(sums, g.nc, col * V + q, eps, w, b);",
         "      k[q] = Fwd<A>{A(0), A(1), A(1), A(1), A(0)};"),
    ],
}
# today's deliberate faults: macros that batchnorm.cu defines
MACROS = {"one_level": "STP_BN_ABLATE_ONE_LEVEL",
          "no_cluster": "STP_BN_ABLATE_NO_CLUSTER",
          "empty": "STP_BN_ABLATE_EMPTY"}


# the first design's launch plan (commit 419b04d), for a source without
# ``stp_bn_occupancy``: four 256-thread blocks on each SM aimed at, one
# geometry for the four kernels
FIRST_BN_GEO = [ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]


def first_plan(rows: bool, outer: int, c: int, inner: int, v: int):
    target, threads = 4 * 132, 256
    if rows:
        tw = min(c // v, 32)
        tiles = -(-(c // v) // tw)
        slices = max(1, min(-(-target // tiles),
                            -(-outer // (8 * (threads // tw)))))
        span = -(-outer // slices)
        return span, -(-outer // span), tw
    m = outer * inner
    slices = max(1, min(-(-target // c), -(-m // (4 * threads * v))))
    span = -(-(-(-m // slices)) // v) * v
    return span, -(-m // span), 0


def first_geometry(x: torch.Tensor, *others: torch.Tensor):
    """Today's ``BN._geometry`` shape (four launch geometries and the
    partial sums' slices) with the first design's plan and arguments."""
    ptrs = x.data_ptr()
    for t in others:
        ptrs |= t.data_ptr()
    b, c, h, w = x.shape
    rows = BN._rows(x)
    outer, inner = (b * h * w, 1) if rows else (b, h * w)
    v = 16 // x.element_size()
    vec = not ptrs & 15 and (c if rows else inner) % v == 0
    span, slices, tw = first_plan(rows, outer, c, inner, v if vec else 1)
    geo = (BN._DTYPES[x.dtype], int(rows), outer, inner, span, c, slices,
           tw, int(vec))
    return (geo, geo, geo, geo, slices)


def patched(src: str, ablation: str, out_dir: Path) -> str:
    """``src`` with the replacements of ``ablation``, written beside the
    builds; each replacement must match exactly once."""
    text = Path(src).read_text()
    for old, new in ABLATIONS[ablation]:
        if text.count(old) != 1:
            raise SystemExit(f"{src}: ablation {ablation} does not match "
                             f"{old!r}")
        text = text.replace(old, new)
    out = out_dir / f"{Path(src).stem}-{ablation}.cu"
    out.write_text(text)
    return str(out)


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


def build(sources: list[str]) -> list[ctypes.CDLL]:
    """Compile every source in parallel into ``_build/compare/``: the
    shared library and, for a ``batchnorm.cu`` version, a cubin for the
    occupancy line.  ``SOURCE:ABLATION`` is patched first."""
    out_dir = K.BUILD_DIR / "compare"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = K.find_nvcc()
    cubin_flags = [f for f in K.NVCC_FLAGS
                   if f not in ("-shared", "-Xcompiler", "-fPIC")]
    procs = []
    for i, spec in enumerate(sources):
        src, _, ablation = spec.partition(":")
        inc = ["-I", str(K.CSRC_DIR)]
        if ablation in MACROS:
            inc.append(f"-D{MACROS[ablation]}")
        elif ablation:
            src = patched(src, ablation, out_dir)
        lib = out_dir / f"{i}-{Path(src).stem}.so"
        cubin = out_dir / f"{i}-{Path(src).stem}.cubin"
        procs.append((spec, lib, cubin, subprocess.Popen(
            [nvcc, *K.NVCC_FLAGS, "-Xptxas", "-v", *inc, "-o", str(lib),
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
            subprocess.Popen([nvcc, *cubin_flags, "-cubin", *inc, "-o",
                              str(cubin), src], stdout=subprocess.PIPE,
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


# where each batch-norm entry point's geometry arguments start
GEO_AT = {"bn_stats": 2, "bn_apply": 3, "bn_grad_stats": 3,
          "bn_grad_apply": 4}


def entry_points(lib: ctypes.CDLL):
    """The port's kernels that ``lib`` exports, with their C signatures,
    and whether they take the first design's geometry where today's
    wrappers give another (then with its arguments)."""
    first = (not hasattr(lib, "stp_bn_occupancy")
             and len(K.BN_GEO) != len(FIRST_BN_GEO))
    fns = {}
    for k in K.KERNELS.values():
        if hasattr(lib, k.symbol):
            fn = getattr(lib, k.symbol)
            argtypes = k.argtypes
            if first and k.name in GEO_AT:
                at = GEO_AT[k.name]
                argtypes = (argtypes[:at] + FIRST_BN_GEO
                            + argtypes[at + len(K.BN_GEO):])
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[k.name] = fn
    if hasattr(lib, "stp_bn_occupancy"):
        fns["occupancy"] = lib.stp_bn_occupancy
    return fns, first


def bn_turn(source: str, fns: dict, first: bool) -> None:
    """The batch-norm kernels of one version through today's wrappers on
    every ``BN_CASES`` case, and the step-weighted totals."""
    saved = {n: K.KERNELS[n]._fn for n in CS.BN_KERNELS}
    geometry, occupancy_fn = BN._geometry, BN._occupancy
    BN._GEOMETRY.clear()
    BN._CARDS.clear()
    try:
        for n in CS.BN_KERNELS:
            K.KERNELS[n]._fn = fns[n]
        if first:
            BN._geometry = first_geometry
        elif "occupancy" in fns:
            fn = fns["occupancy"]
            fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
            BN._occupancy = lambda: fn
        cases = [CS._bn_case(name, shape, dtype, layout, CS.SEED + i,
                             yardsticks=False, strict=False)
                 for i, (name, shape, dtype, layout)
                 in enumerate(CS.BN_CASES)]
    finally:
        for n in CS.BN_KERNELS:
            K.KERNELS[n]._fn = saved[n]
        BN._geometry, BN._occupancy = geometry, occupancy_fn
        BN._GEOMETRY.clear()
        BN._CARDS.clear()
    for c in cases:
        print(json.dumps({"source": source, "case": c["case"],
                          "shape": c["shape"], "dtype": c["dtype"],
                          "layout": c["layout"], "ok": c["ok"],
                          "kernels": {k: {f: r.get(f) for f in (
                              "ms", "bound_ms", "bound_share", "sum_rel",
                              "ulps", "bit_identical_launches")}
                              for k, r in c["kernels"].items()}}),
              flush=True)
    totals = CS.bn_step_totals(cases)
    print(json.dumps({"source": source, "step_totals_ms": {
        k: v["ms"] for k, v in totals.items()}, "step_bound_ms": {
        k: v["bound_ms"] for k, v in totals.items()}}), flush=True)


def bn_copies() -> None:
    """``y.copy_(x)`` on each case's x: ``bn_apply``'s bytes, streamed."""
    for i, (name, shape, dtype, layout) in enumerate(CS.BN_CASES):
        x = CS._bn_inputs(shape, dtype, layout, CS.SEED + i)["x"]
        y = torch.empty_like(x)
        print(json.dumps({"yardstick": "copy_", "case": name,
                          "shape": list(shape),
                          "dtype": str(dtype).split(".")[-1],
                          "layout": layout,
                          "bytes": 2 * x.numel() * x.element_size(),
                          "ms": CS.cuda_ms(lambda: y.copy_(x), 50,
                                           hold=True)}), flush=True)


def main(argv=None) -> int:
    sources = sys.argv[1:] if argv is None else argv
    if not sources:
        print(__doc__, file=sys.stderr)
        return 2
    CS.phase_device()
    versions = [entry_points(lib) for lib in build(sources)]
    aug = any(n in CS.CALLS for fns, _ in versions for n in fns)
    bn = any(n in CS.BN_KERNELS for fns, _ in versions for n in fns)
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
    if bn:
        bn_copies()
    turns = list(range(len(sources)))
    for i in turns + turns[::-1]:
        fns, first = versions[i]
        for name, fn in fns.items():
            if name not in CS.CALLS:
                continue
            kernel = K.KERNELS[name]
            saved, kernel._fn = kernel._fn, fn
            try:
                m = CS.measure_kernel(name, args_of)
            finally:
                kernel._fn = saved
            row = {"source": sources[i], "kernel": name,
                   **{f: m[f] for f in FIELDS}}
            if "passes" in m:
                row["pass_ms"] = [p["ms"] for p in m["passes"]]
                row["pass_bound_ms"] = [p["bound_ms"] for p in m["passes"]]
            print(json.dumps(row), flush=True)
        if all(n in fns for n in CS.BN_KERNELS):  # a batchnorm.cu version
            bn_turn(sources[i], fns, first)
    return 0


if __name__ == "__main__":
    sys.exit(main())
