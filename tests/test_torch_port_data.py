"""The port's serving data layer against the JAX package's.

``utils/rle.py``, the serving half of ``data/datasets.py`` and
``data/batcher.py:prepare_image``/``prepare_mask`` are host numpy and cv2
code; on the same inputs the port must give the same ids, arrays and
errors, bit for bit.
"""

import csv

import cv2
import numpy as np
import pytest

from segmentation_training_pipeline_tpu.data import batcher as JB
from segmentation_training_pipeline_tpu.data import datasets as JD
from segmentation_training_pipeline_tpu.utils import rle as JR
from segmentation_training_pipeline_tpu_torch.data import batcher as TB
from segmentation_training_pipeline_tpu_torch.data import datasets as TD
from segmentation_training_pipeline_tpu_torch.utils import rle as TR

from torch_port_util import few_torch_threads  # noqa: F401


def _same_items(a, b):
    assert a.id == b.id
    np.testing.assert_array_equal(a.x, b.x)
    assert (a.y is None) == (b.y is None)
    if a.y is not None:
        assert a.y.dtype == b.y.dtype
        np.testing.assert_array_equal(a.y, b.y)


@pytest.mark.parametrize("shape", [(7, 5), (1, 1), (16, 3)])
def test_rle_matches_jax(shape):
    r = np.random.RandomState(shape[0])
    for p in (0.0, 0.3, 1.0):
        m = r.rand(*shape) < p
        s = TR.rle_encode(m)
        assert s == JR.rle_encode(m)
        np.testing.assert_array_equal(TR.rle_decode(s, shape),
                                      JR.rle_decode(s, shape))
        np.testing.assert_array_equal(TR.rle_decode(s, shape), m)
    for empty in (None, "", " ", "nan"):
        assert not TR.rle_decode(empty, shape).any()
    with pytest.raises(ValueError, match="past the"):
        TR.rle_decode(f"{shape[0] * shape[1]} 2", shape)


@pytest.fixture
def image_dir(tmp_path):
    """4 images of mixed sizes, masks for 3 of them, and an RLE CSV."""
    r = np.random.RandomState(0)
    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    rows = [["ImageId", "EncodedPixels"]]
    for i, (h, w) in enumerate([(20, 30), (16, 16), (9, 40), (25, 12)]):
        cv2.imwrite(str(tmp_path / "images" / f"a{i}.png"),
                    r.randint(0, 256, (h, w, 3)).astype(np.uint8))
        m = r.rand(h, w) < 0.3
        if i < 3:
            cv2.imwrite(str(tmp_path / "masks" / f"a{i}.png"),
                        m.astype(np.uint8) * 255)
        rows.append([f"a{i}.png", JR.rle_encode(m) if i else ""])
    with open(tmp_path / "labels.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return tmp_path


def test_directory_and_csv_datasets_match_jax(image_dir):
    imgs, masks = str(image_dir / "images"), str(image_dir / "masks")
    pairs = [(TD.DirectoryDataSet(imgs), JD.DirectoryDataSet(imgs)),
             (TD.DirectoryDataSet(imgs, masks),
              JD.DirectoryDataSet(imgs, masks)),
             (TD.CSVRLEDataSet(imgs, str(image_dir / "labels.csv")),
              JD.CSVRLEDataSet(imgs, str(image_dir / "labels.csv")))]
    for t, j in pairs:
        assert len(t) == len(j) == 4
        for i in range(len(j)):
            _same_items(t[i], j[i])
            assert t.image_path(i) == j.image_path(i)
    assert [pairs[2][0].item_is_negative(i) for i in range(4)] == [
        True, False, False, False]
    (image_dir / "empty").mkdir()
    with pytest.raises(ValueError, match="no images"):
        TD.DirectoryDataSet(str(image_dir / "empty"))


def test_wrappers_match_jax():
    xs = [np.full((2, 2, 3), i, np.uint8) for i in range(5)]
    t = TD.CompositeDataSet(TD.LambdaDataSet(xs[:2]),
                            TD.LambdaDataSet(xs[2:], ids=list("cde")))
    j = JD.CompositeDataSet(JD.LambdaDataSet(xs[:2]),
                            JD.LambdaDataSet(xs[2:], ids=list("cde")))
    assert len(t) == len(j) == 5
    for i in (0, 1, 2, 4, -1):
        _same_items(t[i], j[i])
    ts, js = TD.SubDataSet(t, [4, 0, 2]), JD.SubDataSet(j, [4, 0, 2])
    for i in range(3):
        _same_items(ts[i], js[i])
        _same_items(ts.item(i), js.item(i))


@pytest.mark.parametrize("case", [
    "same-size", "resize", "gray-2d", "one-channel", "float01", "float255",
    "to-gray"])
def test_prepare_image_matches_jax(case):
    r = np.random.RandomState(1)
    shape = (32, 32, 1 if case == "to-gray" else 3)
    x = {"same-size": r.randint(0, 256, (32, 32, 3)).astype(np.uint8),
         "resize": r.randint(0, 256, (45, 20, 3)).astype(np.uint8),
         "gray-2d": r.randint(0, 256, (40, 40)).astype(np.uint8),
         "one-channel": r.randint(0, 256, (32, 32, 1)).astype(np.uint8),
         "float01": r.rand(32, 32, 3).astype(np.float32),
         "float255": (r.rand(20, 32, 3) * 300).astype(np.float32),
         "to-gray": r.randint(0, 256, (32, 32, 3)).astype(np.uint8)}[case]
    got, want = TB.prepare_image(x, shape), JB.prepare_image(x, shape)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", [
    "binary255", "binary01", "resize", "none", "softmax-index",
    "softmax-255", "stack", "stack-resize", "sigmoid-2class"])
def test_prepare_mask_matches_jax(case):
    r = np.random.RandomState(2)
    classes, act = 1, "sigmoid"
    if case.startswith("softmax") or case.startswith("stack"):
        classes, act = 3, "softmax"
    if case == "sigmoid-2class":
        classes = 2
    y = {"binary255": (r.rand(24, 24) < 0.5).astype(np.uint8) * 255,
         "binary01": (r.rand(24, 24, 1) < 0.5).astype(np.uint8),
         "resize": (r.rand(30, 17) < 0.5).astype(np.uint8) * 255,
         "none": None,
         "softmax-index": r.randint(0, 3, (24, 24)).astype(np.uint8),
         "softmax-255": (r.rand(24, 24) < 0.5).astype(np.uint8) * 255,
         "stack": (r.rand(24, 24, 3) < 0.5).astype(np.uint8),
         "stack-resize": (r.rand(12, 40, 3) < 0.5).astype(np.uint8) * 255,
         "sigmoid-2class": (r.rand(24, 24) < 0.5).astype(np.uint8)}[case]
    got = TB.prepare_mask(y, (24, 24, 3), classes, act)
    want = JB.prepare_mask(y, (24, 24, 3), classes, act)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="channels"):
        TB.prepare_mask(np.zeros((24, 24, 2)), (24, 24, 3), 3, "softmax")
