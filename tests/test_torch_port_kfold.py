"""The port's training data layer against the JAX package's.

K-fold splits, stratified splits, the test split, the per-epoch index
plans of every ``negatives`` mode, the ``crops`` tile plans, the batches
(bytes, weights, wrap padding, the decode cache) and the synthetic
datasets are host numpy code: on the same inputs the port must give the
same indices and bytes as JAX, exactly.  ``Prefetcher`` keeps the order of
its generator and re-raises a worker's error in the consumer.
"""

import numpy as np
import pytest
import torch

from segmentation_training_pipeline_tpu.data import batcher as JB
from segmentation_training_pipeline_tpu.data import datasets as JD
from segmentation_training_pipeline_tpu.data import synthetic as JS
from segmentation_training_pipeline_tpu_torch import config as TC
from segmentation_training_pipeline_tpu_torch.data import batcher as TB
from segmentation_training_pipeline_tpu_torch.data import datasets as TD
from segmentation_training_pipeline_tpu_torch.data import synthetic as TS

from torch_port_util import few_torch_threads  # noqa: F401

NEGATIVES = [None, "real", "none", 0.5, 1, "2", 100]


def _masks(n, seed, p_neg=0.3):
    """n (8, 8) uint8 masks, about ``p_neg`` of them empty."""
    r = np.random.RandomState(seed)
    ys = []
    for _ in range(n):
        y = (r.rand(8, 8) < 0.3).astype(np.uint8) * 255
        ys.append(y * (r.rand() >= p_neg))
    return ys


def _pair(n, seed, p_neg=0.3):
    xs = [np.full((8, 8, 3), i, np.uint8) for i in range(n)]
    ys = _masks(n, seed, p_neg)
    return JD.LambdaDataSet(xs, ys), TD.LambdaDataSet(xs, ys)


@pytest.mark.parametrize("n,folds,seed", [(10, 5, 33), (23, 5, 33),
                                          (7, 2, 0), (40, 3, 12345)])
def test_kfold_indices_match_jax(n, folds, seed):
    for shuffle in (True, False):
        want = JD.kfold_indices(n, folds, seed, shuffle)
        got = TD.kfold_indices(n, folds, seed, shuffle)
        assert len(got) == folds
        for (jt, jv), (tt, tv) in zip(want, got):
            np.testing.assert_array_equal(tt, jt)
            np.testing.assert_array_equal(tv, jv)
    with pytest.raises(ValueError, match=">= 2"):
        TD.kfold_indices(n, 1)


@pytest.mark.parametrize("seed", [33, 7])
def test_stratified_kfold_indices_match_jax(seed):
    labels = (np.random.RandomState(seed).rand(31) < 0.35).astype(np.int64)
    for (jt, jv), (tt, tv) in zip(JD.stratified_kfold_indices(labels, 4, seed),
                                  TD.stratified_kfold_indices(labels, 4, seed)):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tv, jv)


@pytest.mark.parametrize("test_split,stratified", [(0.0, False),
                                                   (0.2, False),
                                                   (0.0, True), (0.25, True)])
def test_kfolded_plans_match_jax(test_split, stratified):
    """Folds, test split, and the train plans of each negatives mode over
    four epochs and both folds, and the validation plans."""
    jds, tds = _pair(37, 1)
    j = JD.KFoldedDataSet(jds, 3, 33, test_split, stratified)
    t = TD.KFoldedDataSet(tds, 3, 33, test_split, stratified)
    assert len(t) == len(j) == 3
    np.testing.assert_array_equal(t.test_indices, j.test_indices)
    for f in range(3):
        np.testing.assert_array_equal(t.folds[f].train, j.folds[f].train)
        np.testing.assert_array_equal(t.folds[f].val, j.folds[f].val)
        for neg in NEGATIVES:
            np.testing.assert_array_equal(t.val_indices(f, neg),
                                          j.val_indices(f, neg))
            for epoch in range(4):
                for shuffle in (True, False):
                    np.testing.assert_array_equal(
                        t.epoch_indices(f, epoch, neg, shuffle),
                        j.epoch_indices(f, epoch, neg, shuffle),
                        err_msg=f"fold {f} epoch {epoch} negatives {neg}")
        for sub in ("train_subset", "val_subset"):
            assert list(getattr(t, sub)(f).indices) == list(
                getattr(j, sub)(f).indices)
    assert list(t.test_subset().indices) == list(j.test_subset().indices)
    with pytest.raises(ValueError, match="negatives must be"):
        t.epoch_indices(0, 0, "some")


def test_kfolded_uses_the_cheap_negativity_probe():
    """A dataset with ``item_is_negative`` is never decoded for the
    negatives plan; a SubDataSet forwards the probe through its indices."""
    calls = []

    class Probe(TD.LambdaDataSet):
        def item_is_negative(self, i):
            calls.append(i)
            return i % 3 == 0

        def __getitem__(self, i):
            raise AssertionError("decoded")

    ds = Probe([None] * 12)
    t = TD.KFoldedDataSet(ds, 2, 33, stratified=True)
    plan = t.epoch_indices(0, 0, "none")
    assert not any(i % 3 == 0 for i in plan) and len(calls) == 12
    sub = TD.SubDataSet(ds, [3, 4])
    assert sub.item_is_negative(0) and not sub.item_is_negative(1)


def test_config_kfold_and_primary_mode_match_jax():
    from segmentation_training_pipeline_tpu import config as JC

    jds, tds = _pair(20, 2)
    for patch in ({}, {"folds_count": 4, "random_state": 5, "testSplit": 0.1,
                       "stratified": True}):
        d = {"primary_metric": "val_loss", **patch}
        j, t = JC.parse_dict(d).kfold(jds), TC.parse_dict(d).kfold(tds)
        np.testing.assert_array_equal(t.test_indices, j.test_indices)
        for a, b in zip(t.folds, j.folds):
            np.testing.assert_array_equal(a.val, b.val)
    for d in ({"primary_metric": "val_loss"},
              {"metrics": ["dice"], "primary_metric": "val_dice"},
              {"metrics": ["dice"], "primary_metric": "dice",
               "primary_metric_mode": "min"}):
        assert TC.parse_dict(d).primary_mode() == \
            JC.parse_dict(d).primary_mode()


@pytest.mark.parametrize("n", [2, 3])
def test_crops_match_jax(n):
    """Tile items of a non-square parent and the expanded plans, shuffled
    and not."""
    r = np.random.RandomState(n)
    xs = [r.randint(0, 256, (13, 17, 3)).astype(np.uint8) for _ in range(3)]
    ys = [(r.rand(13, 17) < 0.5).astype(np.uint8) for _ in range(3)]
    j = JD.CropAndSplitDataSet(JD.LambdaDataSet(xs, ys), n)
    t = TD.CropAndSplitDataSet(TD.LambdaDataSet(xs, ys), n)
    assert len(t) == len(j) == 3 * n * n
    for i in range(len(j)):
        a, b = t[i], j[i]
        assert a.id == b.id
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.y, b.y)
    plan = np.array([2, 0, 1])
    for seed in (None, 33 * 31 + 7):
        np.testing.assert_array_equal(TD.expand_tile_indices(plan, n, seed),
                                      JD.expand_tile_indices(plan, n, seed))
    with pytest.raises(ValueError, match=">= 2"):
        TD.CropAndSplitDataSet(t, 1)


@pytest.mark.parametrize("classes,activation", [(1, "sigmoid"),
                                                (3, "sigmoid"),
                                                (3, "softmax")])
def test_masks_u8_to_onehot_matches_jax(classes, activation):
    r = np.random.RandomState(classes)
    m = np.stack([r.randint(0, 3, (6, 7)), r.randint(0, 2, (6, 7)) * 255,
                  r.randint(0, 2, (6, 7))]).astype(np.uint8)
    got = TB._masks_u8_to_onehot(m, classes, activation)
    want = JB._masks_u8_to_onehot(m, classes, activation)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"image", "mask", "weight"}
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("use_cache", [False, True])
def test_make_batches_match_jax_lambda(use_cache):
    """Mixed sizes (resized by cv2), a 7-item plan in batches of 3: the
    last batch wraps to the plan's start with weight 0; with the cache a
    second pass gives the same bytes from memory."""
    r = np.random.RandomState(4)
    xs = [r.randint(0, 256, (h, w, 3)).astype(np.uint8)
          for h, w in [(16, 16), (20, 12), (16, 16), (9, 30), (16, 16),
                       (16, 16), (31, 16), (16, 16)]]
    ys = _masks(8, 5)
    plan = np.array([5, 1, 7, 0, 3, 6, 2])
    jc, tc = ({}, {}) if use_cache else (None, None)
    args = ((16, 16, 3), 1, "sigmoid", 3)
    for _ in range(2 if use_cache else 1):
        stats = {}
        want = list(JB.make_batches(JD.LambdaDataSet(xs, ys), plan, *args,
                                    cache=jc))
        got = list(TB.make_batches(TD.LambdaDataSet(xs, ys), plan, *args,
                                   cache=tc, stats=stats))
        _same_batches(got, want)
    assert stats["batches"] == 3 and stats["native"] is False
    np.testing.assert_array_equal(got[-1]["weight"], [1, 0, 0])
    np.testing.assert_array_equal(got[-1]["image"][1], got[0]["image"][0])
    if use_cache:
        assert sorted(tc) == sorted(jc) == sorted(plan.tolist())
    assert list(TB.make_batches(TD.LambdaDataSet(xs, ys), [], *args)) == []


def test_make_batches_match_jax_png_dir(tmp_path):
    """PNG files through ``DirectoryDataSet`` (the JAX package may decode
    them with its native loader; the port decodes item by item) give the
    same bytes, one image without a mask included."""
    import cv2

    (tmp_path / "images").mkdir()
    (tmp_path / "masks").mkdir()
    r = np.random.RandomState(6)
    for i in range(6):
        h, w = (24, 24) if i % 2 else (30, 20)
        cv2.imwrite(str(tmp_path / "images" / f"p{i}.png"),
                    r.randint(0, 256, (h, w, 3)).astype(np.uint8))
        if i != 4:
            cv2.imwrite(str(tmp_path / "masks" / f"p{i}.png"),
                        (r.rand(h, w) < 0.4).astype(np.uint8) * 255)
    dirs = (str(tmp_path / "images"), str(tmp_path / "masks"))
    plan = [3, 0, 5, 4, 1]
    for classes in (1, 2):
        args = ((24, 24, 3), classes, "sigmoid", 4)
        want = list(JB.make_batches(JD.DirectoryDataSet(*dirs), plan, *args))
        got = list(TB.make_batches(TD.DirectoryDataSet(*dirs), plan, *args))
        _same_batches(got, want)


def _gen(n, fail_at=None):
    def gen():
        for i in range(n):
            if i == fail_at:
                raise KeyError(f"item {i}")
            yield {"image": np.full((2, 3), i, np.uint8),
                   "weight": np.ones(2, np.float32)}
    return gen


def test_prefetcher_keeps_order_and_reraises():
    got = [int(b["image"][0, 0]) for b in
           TB.Prefetcher(_gen(9), device="cpu", depth=2)]
    assert got == list(range(9))
    b = next(iter(TB.Prefetcher(_gen(1), device="cpu")))
    assert b["image"].dtype == torch.uint8 and not b["image"].is_pinned()
    seen = []
    with pytest.raises(KeyError, match="item 3"):
        for b in TB.Prefetcher(_gen(9, fail_at=3), device="cpu", depth=1):
            seen.append(int(b["image"][0, 0]))
    assert seen == [0, 1, 2]
    # leaving early stops the worker (the loop's generator is closed)
    it = iter(TB.Prefetcher(_gen(100), device="cpu", depth=1))
    next(it)
    it.close()


@pytest.mark.parametrize("p_empty", [0.0, 0.3])
def test_synthetic_dataset_matches_jax(p_empty):
    j = JS.generate_shapes_dataset(6, 24, seed=3, p_empty=p_empty)
    t = TS.generate_shapes_dataset(6, 24, seed=3, p_empty=p_empty)
    for i in range(6):
        assert t[i].id == j[i].id
        np.testing.assert_array_equal(t[i].x, j[i].x)
        np.testing.assert_array_equal(t[i].y, j[i].y)
    if p_empty:
        assert any(not t[i].y.any() for i in range(6))


def test_synthetic_files_match_jax(tmp_path):
    """``write_shapes_dataset`` writes the JAX package's files byte for
    byte; with ``p_empty`` it writes the items ``generate_shapes_dataset``
    draws."""
    ji, jm = JS.write_shapes_dataset(str(tmp_path / "j"), 4, 24, seed=5)
    ti, tm = TS.write_shapes_dataset(str(tmp_path / "t"), 4, 24, seed=5)
    for jd, td in ((ji, ti), (jm, tm)):
        names = sorted(p.name for p in (tmp_path / "j" / jd.split("/")[-1])
                       .iterdir())
        assert names == [f"shape{i:04d}.png" for i in range(4)]
        for nm in names:
            assert (open(f"{td}/{nm}", "rb").read()
                    == open(f"{jd}/{nm}", "rb").read())
    TS.write_shapes_dataset(str(tmp_path / "e"), 6, 24, seed=3, p_empty=0.3)
    ds = TD.DirectoryDataSet(str(tmp_path / "e" / "images"),
                             str(tmp_path / "e" / "masks"))
    want = TS.generate_shapes_dataset(6, 24, seed=3, p_empty=0.3)
    for i in range(6):
        np.testing.assert_array_equal(ds[i].x, want[i].x)
        np.testing.assert_array_equal(ds[i].y, want[i].y)
