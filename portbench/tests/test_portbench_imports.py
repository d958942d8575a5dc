"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program; the runtime guard compares
top-level names whole."""

import ast
import sys
from pathlib import Path

import pytest

from portbench import common as C

HERE = Path(__file__).resolve().parents[1]
MODULES = sorted(p for p in HERE.rglob("*.py"))


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".", 1)[0]


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax(path):
    bad = {"jax", "jaxlib", "flax", "segmentation_training_pipeline_tpu"}
    assert not bad & set(imported_tops(path))


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    tops = set(imported_tops(path))
    assert "segmentation_training_pipeline_tpu_torch" not in tops
    assert tops <= {"__future__", "contextlib", "math", "typing", "torch",
                    "portbench"}


def test_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "segmentation_training_pipeline_tpu_torch_x",
                        object())
    assert C.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert C.forbidden_loaded() == ["jax.numpy"]
    monkeypatch.setitem(sys.modules, "segmentation_training_pipeline_tpu",
                        object())
    assert "segmentation_training_pipeline_tpu" in C.forbidden_loaded()


def test_run_refuses_without_card(monkeypatch, capsys):
    from portbench import run as R

    monkeypatch.setattr(R.torch.cuda, "is_available", lambda: False)
    assert R.main(["--workload", "unet34-train-512-b128", "--seed",
                   "3000000001", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
