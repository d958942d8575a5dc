"""Faults planted underneath the timed path, for the checks that the
comparison catches them (``tests/`` and ``calibrate.py``).  Each is a
context manager that patches the program while it is open.

  unchanged      the train step returns the state it was given;
  half_batch     the train step sees the first half of the batch (and of
                 its draws and keep masks), its mean taken over those rows;
  altered_answer ``predict_probs`` returns one image's probabilities as
                 1 − p in every call.
"""

from __future__ import annotations

import contextlib

import torch


def _rows(tree, n: int):
    if isinstance(tree, dict):
        return {k: _rows(v, n) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rows(v, n) for v in tree]
    return tree[:n] if isinstance(tree, torch.Tensor) else tree


@contextlib.contextmanager
def _wrap_step_factory(wrap):
    from segmentation_training_pipeline_tpu_torch.train import step as ST

    build = ST.build_train_step

    def patched(*a, **kw):
        return wrap(build(*a, **kw))

    ST.build_train_step = patched
    try:
        yield
    finally:
        ST.build_train_step = build


def unchanged():
    def wrap(step):
        def broken(state, batch, lr, **kw):
            return state, step(state, batch, lr, **kw)[1]
        return broken
    return _wrap_step_factory(wrap)


def half_batch():
    def wrap(step):
        def broken(state, batch, lr, draws=None, drop_masks=None, **kw):
            n = batch["image"].shape[0] // 2
            return step(state, _rows(batch, n), lr, draws=_rows(draws, n),
                        drop_masks=_rows(drop_masks, n), **kw)
        return broken
    return _wrap_step_factory(wrap)


@contextlib.contextmanager
def altered_answer():
    from segmentation_training_pipeline_tpu_torch import infer as IN

    predict = IN.InferenceBundle.predict_probs

    def broken(self, images):
        out = predict(self, images)
        out[0] = 1.0 - out[0]
        return out

    IN.InferenceBundle.predict_probs = broken
    try:
        yield
    finally:
        IN.InferenceBundle.predict_probs = predict


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}
