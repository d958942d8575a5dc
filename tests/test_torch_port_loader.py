"""The port's thread-pool decode (``data/loader.py``) against the JAX
package's native C++ loader (``native.NativeLoader.load_batch``), and
``make_batches`` on a ``DirectoryDataSet`` against the JAX batcher, which
takes its native loader for such a dataset.

The test writes its own files: PNG and JPEG images, RGB and gray on disk,
read at C = 3 and C = 1; gray and RGB mask files; sizes equal to the
config's and not (both resizes, each way); and missing files.  Tolerance:
none, the bytes are equal.
"""

import os
import threading

import cv2
import numpy as np
import pytest

from segmentation_training_pipeline_tpu.data import batcher as JB
from segmentation_training_pipeline_tpu.data.datasets import (
    DirectoryDataSet as JDir)
from segmentation_training_pipeline_tpu.native import NativeLoader
from segmentation_training_pipeline_tpu_torch.data import batcher as TB
from segmentation_training_pipeline_tpu_torch.data import loader as TL
from segmentation_training_pipeline_tpu_torch.data.datasets import (
    DirectoryDataSet as TDir, LambdaDataSet)

from torch_port_util import few_torch_threads

H, W = 32, 40
# (stem, image extension, image size (h, w), gray on disk, mask kind)
ITEMS = [("a", ".png", (32, 40), False, "gray"),
         ("b", ".png", (45, 51), False, "gray-big"),
         ("c", ".jpg", (32, 40), False, "rgb"),
         ("d", ".jpg", (27, 33), False, "none"),
         ("e", ".png", (32, 40), True, "gray-small"),
         ("f", ".png", (50, 30), True, "rgb-big"),
         ("g", ".png", (32, 40), False, "index")]


def _write_items(root):
    r = np.random.RandomState(0)
    images, masks = root / "images", root / "masks"
    images.mkdir()
    masks.mkdir()
    for stem, ext, (h, w), gray, kind in ITEMS:
        yy, xx = np.mgrid[0:h, 0:w]
        img = (r.rand(h, w, 3) * 255).astype(np.uint8)
        img[..., 1] = ((yy * 7 + xx * 3) % 256).astype(np.uint8)
        cv2.imwrite(str(images / f"{stem}{ext}"),
                    img[..., 0] if gray else img)
        if kind == "none":
            continue
        mh, mw = {"gray-big": (45, 51), "gray-small": (20, 25),
                  "rgb-big": (48, 44)}.get(kind, (H, W))
        disc = ((np.mgrid[0:mh, 0:mw][0] - mh / 2) ** 2
                + (np.mgrid[0:mh, 0:mw][1] - mw / 3) ** 2 < (mh / 3) ** 2)
        m = disc.astype(np.uint8) * (2 if kind == "index" else 255)
        if kind.startswith("rgb"):
            m = np.stack([m, m // 2, m], -1)       # gray by luma on read
        cv2.imwrite(str(masks / f"{stem}.png"), m)
    return str(images), str(masks)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _write_items(tmp_path_factory.mktemp("loader"))


@pytest.fixture(scope="module")
def native():
    loader = NativeLoader()
    yield loader
    loader.close()


def _paths(files, extra_image=None, extra_mask=None):
    ds = TDir(*files)
    ipaths = [ds.image_path(i) for i in range(len(ds))]
    mpaths = [ds.mask_path(i) for i in range(len(ds))]
    if extra_image:
        ipaths.append(extra_image)
        mpaths.append(extra_mask)
    return ipaths, mpaths


@pytest.mark.parametrize("c", [3, 1])
@pytest.mark.parametrize("size", [(H, W), (24, 24)])
def test_pool_equals_the_native_loader(files, native, c, size):
    ipaths, mpaths = _paths(files)
    assert mpaths[3] is None                   # an item without a mask
    want = native.load_batch(ipaths, mpaths, *size, c)
    pool = TL.DecodePool(3)
    try:
        got = pool.load_batch(ipaths, mpaths, *size, c)
    finally:
        pool.close()
    assert got[2] == want[2] == 0
    assert got[0].shape == want[0].shape == (len(ITEMS), *size, c)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert not got[1][3].any()


def test_pool_without_masks(files, native):
    ipaths, _ = _paths(files)
    want = native.load_batch(ipaths, None, H, W, 3)
    got = TL.default_pool().load_batch(ipaths, None, H, W, 3)
    assert got[1] is None and want[1] is None
    assert np.array_equal(got[0], want[0])


@pytest.mark.parametrize("missing", ["image", "mask", "both"])
def test_pool_counts_failures_as_the_native_loader(files, native, tmp_path,
                                                   missing):
    ipaths, mpaths = _paths(files)
    gone = str(tmp_path / "gone.png")
    ipaths.append(gone if missing in ("image", "both") else ipaths[0])
    mpaths.append(gone if missing in ("mask", "both") else mpaths[0])
    want = native.load_batch(ipaths, mpaths, H, W, 3)[2]
    got = TL.default_pool().load_batch(ipaths, mpaths, H, W, 3)[2]
    assert got == want == (2 if missing == "both" else 1)


def test_pool_threads_default_to_the_cpus_and_lower_their_priority():
    assert TL.DecodePool().threads == os.cpu_count()
    pool = TL.DecodePool(2)
    try:
        assert pool.threads == 2
        main = os.getpriority(os.PRIO_PROCESS, threading.get_native_id())
        nice = pool._pool.submit(lambda: os.getpriority(
            os.PRIO_PROCESS, threading.get_native_id())).result()
    finally:
        pool.close()
    assert nice == min(main + TL._NICE, 19)
    assert os.getpriority(os.PRIO_PROCESS, threading.get_native_id()) == main


@pytest.mark.parametrize("classes,activation,c,batch", [
    (1, "sigmoid", 3, 3), (2, "sigmoid", 1, 4), (3, "softmax", 3, 5)])
def test_make_batches_equals_jax_on_a_directory(files, classes, activation,
                                                c, batch):
    """Same order, bytes, one-hot masks, weights and wrap padding; the
    plan is out of order and the last batch partial."""
    plan = [6, 1, 4, 0, 5, 2, 3]
    stats = {}
    got = list(TB.make_batches(TDir(*files), plan, (H, W, c), classes,
                               activation, batch, stats=stats))
    want = list(JB.make_batches(JDir(*files), plan, (H, W, c), classes,
                                activation, batch))
    assert stats["native"] is True
    assert stats["decode_threads"] == os.cpu_count()
    assert stats["batches"] == len(got) == len(want) == -(-len(plan) // batch)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "mask", "weight"}
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    assert got[-1]["weight"].sum() == len(plan) - batch * (len(got) - 1)


def test_make_batches_raises_with_the_failure_count(files, tmp_path):
    """A file that vanished after the listing: the batch raises, as the
    JAX batcher does, and nothing falls back to the per-item path."""
    images = tmp_path / "images"
    images.mkdir()
    for f in sorted(os.listdir(files[0]))[:3]:
        os.link(os.path.join(files[0], f), images / f)
    ds = TDir(str(images), files[1])
    os.unlink(images / sorted(os.listdir(images))[1])
    with pytest.raises(IOError, match="failed on 1 of 3 files"):
        list(TB.make_batches(ds, [0, 1, 2], (H, W, 3), 1, "sigmoid", 3))


def test_other_datasets_decode_item_by_item():
    r = np.random.RandomState(1)
    ds = LambdaDataSet([(r.rand(H, W, 3) * 255).astype(np.uint8)
                        for _ in range(3)])
    stats = {}
    out = list(TB.make_batches(ds, [0, 1, 2], (H, W, 3), 1, "sigmoid", 2,
                               stats=stats))
    assert stats["native"] is False and stats["decode_threads"] == 0
    assert np.array_equal(out[0]["image"][0], ds[0].x)
