"""Host-side training callbacks (Keras names).

Counterpart of ``segmentation_training_pipeline_tpu/train/callbacks.py``:
the same classes, arguments and arithmetic.  They run on the host at epoch
and batch boundaries and change a ``TrainingControl`` (a stop flag, a
learning-rate scale and a per-batch override), never the step: the lr is
a runtime argument of the train step.  ``ModelCheckpoint`` is the fit
loop's own (``train/stage.py``); its YAML entry is accepted and ignored.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional


@dataclass
class TrainingControl:
    base_lr: float
    lr_scale: float = 1.0
    batch_lr: Optional[float] = None  # per-batch override (CyclicLR)
    stop_training: bool = False
    global_step: int = 0

    @property
    def effective_lr(self) -> float:
        if self.batch_lr is not None:
            return self.batch_lr * self.lr_scale
        return self.base_lr * self.lr_scale


def _mode_for(monitor: str, mode: str = "auto") -> str:
    if mode in ("min", "max"):
        return mode
    name = monitor.replace("val_", "")
    return "min" if ("loss" in name or "error" in name) else "max"


class Callback:
    def on_train_begin(self, control: TrainingControl):
        pass

    def on_batch_begin(self, control: TrainingControl):
        pass

    def on_epoch_end(self, epoch: int, logs: Dict[str, float],
                     control: TrainingControl):
        pass

    def on_train_end(self, control: TrainingControl):
        pass


class EarlyStopping(Callback):
    def __init__(self, monitor: str = "val_loss", patience: int = 0,
                 min_delta: float = 0.0, mode: str = "auto", verbose: int = 0,
                 restore_best_weights: bool = False, **_ignored):
        self.monitor = monitor
        self.patience = int(patience)
        self.min_delta = abs(float(min_delta))
        self.mode = _mode_for(monitor, mode)
        self.verbose = verbose
        self.best = math.inf if self.mode == "min" else -math.inf
        self.wait = 0

    def on_epoch_end(self, epoch, logs, control):
        cur = logs.get(self.monitor)
        if cur is None:
            return
        improved = (cur < self.best - self.min_delta) if self.mode == "min" \
            else (cur > self.best + self.min_delta)
        if improved:
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait > self.patience:
                control.stop_training = True
                if self.verbose:
                    print(f"EarlyStopping: stop at epoch {epoch} "
                          f"({self.monitor} best={self.best:.5f})")


class ReduceLROnPlateau(Callback):
    def __init__(self, monitor: str = "val_loss", factor: float = 0.1,
                 patience: int = 10, min_delta: float = 1e-4,
                 cooldown: int = 0, min_lr: float = 0.0, mode: str = "auto",
                 verbose: int = 0, **_ignored):
        self.monitor = monitor
        self.factor = float(factor)
        self.patience = int(patience)
        self.min_delta = abs(float(min_delta))
        self.cooldown = int(cooldown)
        self.min_lr = float(min_lr)
        self.mode = _mode_for(monitor, mode)
        self.verbose = verbose
        self.best = math.inf if self.mode == "min" else -math.inf
        self.wait = 0
        self.cooldown_counter = 0

    def on_epoch_end(self, epoch, logs, control):
        cur = logs.get(self.monitor)
        if cur is None:
            return
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.wait = 0
        improved = (cur < self.best - self.min_delta) if self.mode == "min" \
            else (cur > self.best + self.min_delta)
        if improved:
            self.best = cur
            self.wait = 0
        elif self.cooldown_counter <= 0:
            self.wait += 1
            if self.wait >= self.patience:
                old = control.base_lr * control.lr_scale
                new = max(old * self.factor, self.min_lr)
                if new < old:
                    control.lr_scale = new / control.base_lr
                    if self.verbose:
                        print(f"ReduceLROnPlateau: lr {old:.2e} -> {new:.2e}")
                self.cooldown_counter = self.cooldown
                self.wait = 0


class CyclicLR(Callback):
    """Triangular cyclic LR (Smith 2017)."""

    def __init__(self, base_lr: float = 1e-4, max_lr: float = 6e-3,
                 step_size: int = 2000, mode: str = "triangular",
                 gamma: float = 1.0, **_ignored):
        self.base_lr = float(base_lr)
        self.max_lr = float(max_lr)
        self.step_size = int(step_size)
        self.mode = mode
        self.gamma = float(gamma)

    def on_batch_begin(self, control):
        it = control.global_step
        cycle = math.floor(1 + it / (2 * self.step_size))
        x = abs(it / self.step_size - 2 * cycle + 1)
        amp = self.max_lr - self.base_lr
        if self.mode == "triangular2":
            amp = amp / (2.0 ** (cycle - 1))
        elif self.mode == "exp_range":
            amp = amp * (self.gamma ** it)
        control.batch_lr = self.base_lr + amp * max(0.0, 1.0 - x)


class LRVariator(Callback):
    """Linear (or cosine) ramp between two LRs over N steps."""

    def __init__(self, fromVal: Optional[float] = None, toVal: float = 1e-3,
                 style: str = "linear", steps: int = 1000, **_ignored):
        self.from_val = fromVal
        self.to_val = float(toVal)
        self.steps = int(steps)
        self.style = style

    def on_batch_begin(self, control):
        start = self.from_val if self.from_val is not None else control.base_lr
        t = min(1.0, control.global_step / max(1, self.steps))
        if self.style == "cos":
            t = 0.5 * (1 - math.cos(math.pi * t))
        control.batch_lr = start + (self.to_val - start) * t


class TerminateOnNaN(Callback):
    def on_epoch_end(self, epoch, logs, control):
        loss = logs.get("loss")
        if loss is not None and not math.isfinite(loss):
            print(f"TerminateOnNaN: non-finite loss at epoch {epoch}")
            control.stop_training = True


class LearningRateScheduler(Callback):
    """Epoch → lr-scale mapping from YAML (``schedule: {0: 1e-3, 10: 1e-4}``).

    The Keras original takes a Python callable, which YAML can't express;
    the dict form covers the declarative use-case.
    """

    def __init__(self, schedule: Optional[Dict[int, float]] = None,
                 verbose: int = 0, **_ignored):
        self.schedule = {int(k): float(v) for k, v in (schedule or {}).items()}
        self.verbose = verbose

    def _apply(self, epoch, control):
        if epoch in self.schedule:
            control.lr_scale = self.schedule[epoch] / control.base_lr
            if self.verbose:
                print(f"LearningRateScheduler: lr -> "
                      f"{self.schedule[epoch]:.2e}")

    def on_train_begin(self, control):
        # Keras applies schedule(epoch) at epoch BEGIN — without this the
        # epoch-0 entry (warmup/initial lr) would silently never fire
        self._apply(0, control)

    def on_epoch_end(self, epoch, logs, control):
        self._apply(epoch + 1, control)


class CSVLogger(Callback):
    """metrics/metrics-{fold}.{stage}.csv: ``epoch,lr,<log keys>`` rows."""

    def __init__(self, path: str, append: bool = False, **_ignored):
        self.path = path
        self.append = append
        self._file = None
        self._keys: Optional[List[str]] = None

    def on_train_begin(self, control):
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if self.append and os.path.exists(self.path):
            # crash-resume: keep the existing history and adopt its header
            # so we don't write a second header line mid-file
            with open(self.path) as f:
                header = f.readline().strip()
            if header:
                cols = header.split(",")
                self._keys = [c for c in cols if c not in ("epoch", "lr")]
        self._file = open(self.path, "a" if self.append else "w")

    def on_epoch_end(self, epoch, logs, control):
        if self._file is None:
            return
        if self._keys is None:
            self._keys = list(logs.keys())
            self._file.write(",".join(["epoch", "lr"] + self._keys) + "\n")
        row = [str(epoch), f"{control.effective_lr:.8g}"]
        row += [f"{logs.get(k, float('nan')):.6g}" for k in self._keys]
        self._file.write(",".join(row) + "\n")
        self._file.flush()

    def on_train_end(self, control):
        if self._file:
            self._file.close()
            self._file = None


class TensorBoard(Callback):
    """``tfevents`` scalar logging without TensorFlow (utils/tfevents.py
    hand-encodes the TFRecord + Event-proto format), one record per
    epoch.  In a process group only the primary opens a writer."""

    def __init__(self, log_dir: str = "./logs", **_ignored):
        self.log_dir = log_dir
        self._writer = None

    def on_train_begin(self, control):
        from ..parallel import distributed as dist

        if not dist.is_primary():
            return  # one event writer per shared filesystem
        from ..utils.tfevents import EventFileWriter

        self._writer = EventFileWriter(self.log_dir)

    def on_epoch_end(self, epoch, logs, control):
        if self._writer:
            scalars = {"lr": control.effective_lr}
            scalars.update({k: v for k, v in logs.items()
                            if isinstance(v, (int, float))})
            # TensorBoard steps are 1-based epochs here (step 0 would
            # collide with the file_version record's implicit step)
            self._writer.add_scalars(epoch + 1, scalars)

    def on_train_end(self, control):
        if self._writer:
            self._writer.close()
            self._writer = None


_CALLBACKS = {
    "earlystopping": EarlyStopping,
    "reducelronplateau": ReduceLROnPlateau,
    "cycliclr": CyclicLR,
    "lrvariator": LRVariator,
    "terminateonnan": TerminateOnNaN,
    "learningratescheduler": LearningRateScheduler,
    "csvlogger": CSVLogger,
    "tensorboard": TensorBoard,
    # ModelCheckpoint is built into the stage runner (always-on, reference
    # behavior); an explicit entry just overrides its monitor/mode.
}


def instantiate(spec: Dict[str, Any], directory: str) -> Optional[Callback]:
    name = spec["name"].lower()
    args = dict(spec.get("args", {}))
    if name == "modelcheckpoint":
        return None  # handled by the stage runner
    if name == "csvlogger":
        from ..parallel import distributed as dist

        if not dist.is_primary():
            return None  # one CSV writer per shared filesystem
        path = args.pop("filename", None) or args.pop("path", None)
        if path and not os.path.isabs(path):
            path = os.path.join(directory, path)
        return CSVLogger(path or os.path.join(directory, "log.csv"), **args)
    if name == "tensorboard":
        ld = args.pop("log_dir", "./logs")
        if not os.path.isabs(ld):
            ld = os.path.join(directory, ld)
        return TensorBoard(log_dir=ld, **args)
    cls = _CALLBACKS.get(name)
    if cls is None:
        raise KeyError(f"unknown callback {spec['name']!r}")
    return cls(**args)
