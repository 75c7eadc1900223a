"""paddle.callbacks (port of ``paddle_tpu/callbacks.py:20-266``): the
``Callback`` hooks that ``Model.fit`` calls, ``CallbackList``,
``ProgBarLogger``, ``ModelCheckpoint``, ``EarlyStopping``, ``LRScheduler``
(steps the optimizer's scheduler), ``LogWriterCallback`` (JSON lines, the
reference's VisualDL stand-in) and ``ReduceLROnPlateau``. Not ported:
``TelemetryCallback`` and ``VisualDL``, which need ``profiler/``.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "LogWriterCallback",
           "ReduceLROnPlateau"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = dict(params or {})

    # hook surface (reference names)
    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks, model=None, params=None):
        self.callbacks = list(callbacks or [])
        for c in self.callbacks:
            c.set_model(model)
            c.set_params(params)

    def _call(self, name, *args):
        for c in self.callbacks:
            getattr(c, name)(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *a: self._call(name, *a)
        raise AttributeError(name)

    @property
    def stop_training(self):
        return any(getattr(c, "stop_training", False)
                   for c in self.callbacks)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=10, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self._epoch = epoch
        self._t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            logs = logs or {}
            msg = " ".join(f"{k}: {v:.4f}" if isinstance(v, float) else
                           f"{k}: {v}" for k, v in logs.items())
            rate = (time.time() - self._t0) / (step + 1)
            print(f"Epoch {self._epoch} step {step} {msg} ({rate:.3f}s/step)")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            self.model.save(os.path.join(self.save_dir, f"epoch_{epoch}"))

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        # the baseline seeds `best` — the metric must beat
        # it within `patience` evals or training stops
        self.best = baseline
        self.wait = 0
        self.stop_training = False
        self.save_dir = None

    def _better(self, cur):
        if self.best is None:
            return True
        if self.mode == "min":
            return cur < self.best - self.min_delta
        return cur > self.best + self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).reshape(-1)[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.save_dir and self.model:
                self.model.save(os.path.join(self.save_dir, "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (by_step or by_epoch)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        assert by_step != by_epoch
        self.by_step = by_step

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None)
        return lr if hasattr(lr, "step") else None

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if not self.by_step and s is not None:
            s.step()


class LogWriterCallback(Callback):
    """JSONL metrics writer (VisualDL stand-in). File opens lazily on
    train begin so one instance survives multiple fit() calls."""

    def __init__(self, log_dir="./vdl_log"):
        super().__init__()
        self.log_dir = log_dir
        self._f = None

    def on_train_begin(self, logs=None):
        if self._f is None or self._f.closed:
            os.makedirs(self.log_dir, exist_ok=True)
            self._f = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")

    def on_train_batch_end(self, step, logs=None):
        if self._f is None or self._f.closed:
            return
        rec = {"step": step}
        for k, v in (logs or {}).items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                pass
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def on_train_end(self, logs=None):
        if self._f is not None and not self._f.closed:
            self._f.close()


class ReduceLROnPlateau(Callback):
    """Reduce optimizer LR when a monitored metric plateaus (reference:
    ``paddle.callbacks.ReduceLROnPlateau``)."""

    def __init__(self, monitor="loss", factor=0.1, patience=10, verbose=1,
                 mode="auto", min_delta=1e-4, cooldown=0, min_lr=0.0):
        super().__init__()
        self.monitor = monitor
        self.factor = factor
        self.patience = patience
        self.verbose = verbose
        self.mode = mode
        self.min_delta = min_delta
        self.cooldown = cooldown
        self.min_lr = min_lr
        self._best = None
        self._wait = 0
        self._cooldown_ctr = 0

    def _better(self, cur, best):
        if self.mode == "max" or (self.mode == "auto"
                                  and "acc" in self.monitor):
            return cur > best + self.min_delta
        return cur < best - self.min_delta

    def on_eval_end(self, logs=None):
        logs = logs or {}
        cur = logs.get(self.monitor)
        if cur is None:
            return
        cur = float(cur[0] if isinstance(cur, (list, tuple)) else cur)
        if self._cooldown_ctr > 0:
            # hold period after a reduction: track the best but never
            # count toward patience
            self._cooldown_ctr -= 1
            self._wait = 0
            if self._best is None or self._better(cur, self._best):
                self._best = cur
            return
        if self._best is None or self._better(cur, self._best):
            self._best = cur
            self._wait = 0
            return
        self._wait += 1
        if self._wait >= self.patience:
            opt = getattr(self.model, "_optimizer", None)
            if opt is not None:
                lr = opt.get_lr() if hasattr(opt, "get_lr") else opt._learning_rate
                new_lr = max(lr * self.factor, self.min_lr)
                if hasattr(opt, "set_lr"):
                    opt.set_lr(new_lr)
                if self.verbose:
                    print(f"ReduceLROnPlateau: lr -> {new_lr:.3e}")
            self._wait = 0
            self._cooldown_ctr = self.cooldown
