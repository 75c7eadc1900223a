"""paddle.Model, ``summary`` and ``flops`` (port of
``paddle_tpu/hapi.py:40-363``).

``Model(network).prepare(optimizer, loss, metrics)`` then ``fit``,
``evaluate``, ``predict`` and the ``*_batch`` steps, as the reference
runs them:

* ``prepare`` takes ``amp_configs`` and ignores it (``:75-79``): mixed
  precision is the caller's ``amp.decorate`` and ``auto_cast``;
* ``fit`` steps the optimizer every ``accumulate_grad_batches`` batches,
  stops after ``num_iters`` steps, evaluates every ``eval_freq`` epochs
  and saves every ``save_freq``;
* the loss is read back (a device sync) only when a callback or
  ``verbose`` printing consumes the logs;
* the trailing smaller batch of an epoch is padded to the first batch's
  size (repeating its last sample; the outputs are sliced back before the
  loss) only for a ``to_static`` network without BatchNorm, which would
  otherwise compile a second program;
* ``save`` and ``load`` write and read ``.pdparams`` and ``.pdopt``
  through ``paddle.save`` and ``paddle.load``.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .framework import io as fio
from .io import DataLoader


def _pad_rows(x, target):
    """Inputs padded along axis 0 to ``target`` rows by repeating the last
    (labels are never padded)."""
    if isinstance(x, (list, tuple)):
        return type(x)(_pad_rows(v, target) for v in x)
    if isinstance(x, torch.Tensor) and x.dim() > 0 and x.shape[0] < target:
        pad = x[-1:].expand(target - x.shape[0], *x.shape[1:])
        return torch.cat([x, pad])
    return x


def _slice_rows(out, n):
    """The network's outputs without the pad rows (their gradient is
    zero, so the step equals the unpadded batch's)."""
    if isinstance(out, (list, tuple)):
        return type(out)(_slice_rows(v, n) for v in out)
    if isinstance(out, torch.Tensor) and out.dim() > 0 and out.shape[0] > n:
        return out[:n]
    return out


def _numpy(t):
    return t.numpy(force=True) if isinstance(t, torch.Tensor) else t


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._optimizer = None
        self._loss = None
        self._metrics = []

    # -- the trailing partial batch -------------------------------------------
    def _pad_partial_enabled(self):
        """Pad an epoch's last, smaller batch up to the compiled shape
        instead of compiling a second program: only for a ``to_static``
        network, and only without batch-coupled normalization, whose
        statistics would see the pad rows."""
        if getattr(self.network, "_static_forward", None) is None:
            return False
        return not any("BatchNorm" in type(m).__name__
                       for m in self.network.modules())

    def _maybe_pad_partial(self, x, st):
        if not st["enabled"]:
            return x, None
        lead = x[0] if isinstance(x, (list, tuple)) else x
        if not isinstance(lead, torch.Tensor) or lead.dim() == 0:
            return x, None
        n = lead.shape[0]
        if st["spec"] is None:          # the first batch sets the shape
            st["spec"] = n
            return x, None
        if n >= st["spec"]:
            return x, None
        return _pad_rows(x, st["spec"]), n

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        self._loss = loss
        metrics = metrics or []
        self._metrics = metrics if isinstance(metrics, (list, tuple)) \
            else [metrics]

    @staticmethod
    def _unpack(batch):
        if isinstance(batch, (list, tuple)) and len(batch) >= 2:
            *inputs, label = batch
            if len(inputs) == 1:
                return inputs[0], label
            return inputs, label
        return batch, None

    def _forward(self, inputs):
        return self.network(*inputs) if isinstance(inputs, (list, tuple)) \
            else self.network(inputs)

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        out = self._forward(inputs)
        loss = self._loss(out, labels) if self._loss else out
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [_numpy(loss)]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        out = self._forward(inputs)
        loss = self._loss(out, labels) if self._loss else out
        return [_numpy(loss)]

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        return [_numpy(self._forward(inputs))]

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        from .callbacks import CallbackList, EarlyStopping, ProgBarLogger
        loader = train_data if isinstance(train_data, DataLoader) \
            else DataLoader(train_data, batch_size=batch_size,
                            shuffle=shuffle, drop_last=drop_last,
                            num_workers=num_workers)
        cbs = CallbackList(callbacks, model=self,
                           params={"epochs": epochs, "batch_size": batch_size,
                                   "verbose": verbose})
        for c in cbs.callbacks:         # EarlyStopping's best-model dir
            if isinstance(c, EarlyStopping) and c.save_dir is None:
                c.save_dir = save_dir
        cbs.on_train_begin({})
        it = 0
        pad_state = {"enabled": self._pad_partial_enabled(), "spec": None}
        have_cbs = bool(cbs.callbacks)
        own_print = verbose and not any(
            isinstance(c, ProgBarLogger) for c in cbs.callbacks)
        for epoch in range(epochs):
            self.network.train()
            for m in self._metrics:
                m.reset()
            cbs.on_epoch_begin(epoch, {})
            t0 = time.time()
            logs = {}
            for step, batch in enumerate(loader):
                if have_cbs:
                    cbs.on_train_batch_begin(step, {})
                x, y = self._unpack(batch)
                x, true_n = self._maybe_pad_partial(x, pad_state)
                out = self.network(x)
                if true_n is not None:
                    out = _slice_rows(out, true_n)
                loss = self._loss(out, y) if self._loss else out
                loss.backward()
                if (step + 1) % accumulate_grad_batches == 0:
                    self._optimizer.step()
                    self._optimizer.clear_grad()
                for m in self._metrics:
                    m.update(m.compute(out, y))
                it += 1
                # the logs sync the device (the loss read back): only when
                # something consumes them
                if have_cbs:
                    logs = {"loss": float(loss.detach())}
                    logs.update({m.name(): m.accumulate()
                                 for m in self._metrics})
                    cbs.on_train_batch_end(step, logs)
                if own_print and step % log_freq == 0:
                    metr = {m.name(): m.accumulate() for m in self._metrics}
                    print(f"Epoch {epoch + 1}/{epochs} step {step} "
                          f"loss: {float(loss.detach()):.4f} {metr} "
                          f"({(time.time() - t0) / (step + 1):.3f}s/step)")
                if num_iters is not None and it >= num_iters:
                    cbs.on_epoch_end(epoch, logs)
                    cbs.on_train_end(logs)
                    return
            cbs.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                cbs.on_eval_begin({})
                ev = self.evaluate(eval_data, batch_size=batch_size,
                                   verbose=verbose)
                cbs.on_eval_end(ev)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(os.path.join(save_dir, f"epoch_{epoch}"))
            if cbs.stop_training:
                break
        cbs.on_train_end({})

    @torch.no_grad()
    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        loader = eval_data if isinstance(eval_data, DataLoader) \
            else DataLoader(eval_data, batch_size=batch_size,
                            num_workers=num_workers)
        self.network.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        for step, batch in enumerate(loader):
            x, y = self._unpack(batch)
            out = self.network(x)
            if self._loss:
                losses.append(float(self._loss(out, y)))
            for m in self._metrics:
                m.update(m.compute(out, y))
            if num_iters is not None and step + 1 >= num_iters:
                break
        result = {m.name(): m.accumulate() for m in self._metrics}
        if losses:
            result["loss"] = float(np.mean(losses))
        if verbose:
            print("Eval:", result)
        return result

    @torch.no_grad()
    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = test_data if isinstance(test_data, DataLoader) \
            else DataLoader(test_data, batch_size=batch_size,
                            num_workers=num_workers)
        self.network.eval()
        outputs = []
        for batch in loader:
            x, _ = self._unpack(batch)
            outputs.append(self.predict_batch([x])[0])
        if stack_outputs:
            return [np.concatenate(outputs)]
        return [outputs]

    def save(self, path, training=True):
        fio.save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        """Read the checkpoint onto the network's device."""
        dev = _device_of(self.network)
        self.network.set_state_dict(fio.load(path + ".pdparams", device=dev))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(opt_path):
            self._optimizer.set_state_dict(fio.load(opt_path, device=dev))

    def parameters(self):
        return self.network.parameters()


def _device_of(net):
    """The device of the network's first parameter (the CPU without
    one)."""
    p = next(iter(net.parameters()), None)
    return p.device if p is not None else torch.device("cpu")


def _trainable(p):
    return getattr(p, "trainable", p.requires_grad)


def summary(net, input_size=None, dtypes=None, input=None):
    """paddle.summary: a table of the parameters; returns the total and
    trainable counts."""
    rows = []
    total = trainable = 0
    for name, p in net.named_parameters():
        n = p.numel()
        total += n
        if _trainable(p):
            trainable += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    lines = [f"{'Layer (param)':<{width}}{'Shape':<24}{'Param #':>12}"]
    lines += [f"{r[0]:<{width}}{str(r[1]):<24}{r[2]:>12,}" for r in rows]
    lines.append(f"Total params: {total:,}")
    lines.append(f"Trainable params: {trainable:,}")
    print("\n".join(lines))
    return {"total_params": total, "trainable_params": trainable}


def _numel(shape):
    return int(np.prod([s for s in shape if s]))


def _layer_flops(layer, inp, out, custom_ops):
    """One leaf layer's FLOPs by Paddle's ``dynamic_flops`` rules: a
    multiply-add is one FLOP and the bias counts."""
    x = inp[0] if isinstance(inp, (tuple, list)) else inp
    y = out[0] if isinstance(out, (tuple, list)) else out
    cls = type(layer)
    if cls in custom_ops:
        return custom_ops[cls](layer, inp, out)
    name = cls.__name__
    bias = 1 if getattr(layer, "bias", None) is not None else 0
    if name in ("Conv2D", "Conv1D", "Conv3D", "Conv2DTranspose",
                "Conv1DTranspose", "Conv3DTranspose"):
        cin = layer._in_channels // getattr(layer, "_groups", 1)
        return _numel(y.shape) * (cin * _numel(layer._kernel_size) + bias)
    if name == "Linear":
        return _numel(y.shape) * (layer.weight.shape[1] + bias)
    if name in ("BatchNorm2D", "BatchNorm1D", "BatchNorm3D", "BatchNorm",
                "LayerNorm", "GroupNorm", "InstanceNorm2D"):
        return 2 * _numel(x.shape)
    if name in ("ReLU", "ReLU6", "GELU", "Sigmoid", "Tanh", "Hardswish",
                "Hardsigmoid", "SiLU", "Silu", "Swish", "LeakyReLU",
                "Softmax") or "Pool" in name:
        return _numel(y.shape)
    return 0


def flops(net, input_size, custom_ops=None, print_detail=False):
    """paddle.flops: one forward of zeros of ``input_size`` (on the
    network's device) with a hook on every leaf layer; returns the total
    FLOPs. ``custom_ops`` maps layer classes to ``fn(layer, input,
    output) -> flops``."""
    custom_ops = custom_ops or {}
    counts = []            # (path, class name, flops, params)
    seen = set()           # layers whose parameters are counted

    def record(path, layer, inp, out):
        params = 0
        if id(layer) not in seen:       # a shared layer counts once
            seen.add(id(layer))
            params = sum(p.numel() for p in layer.parameters())
        counts.append((path, type(layer).__name__,
                       _layer_flops(layer, inp, out, custom_ops), params))

    handles = []

    def attach(layer, prefix=""):
        for n, child in layer.named_children():
            path = f"{prefix}.{n}" if prefix else n
            if not list(child.children()):
                handles.append(child.register_forward_hook(
                    lambda m, i, o, _p=path: record(_p, m, i, o)))
            else:
                attach(child, path)

    attach(net)
    if not handles and not list(net.children()):
        handles.append(net.register_forward_hook(
            lambda m, i, o: record("(root)", m, i, o)))
    # each layer's own training flag, put back after
    modes = [(m, m.training) for m in net.modules()]
    net.eval()
    try:
        with torch.no_grad():
            net(torch.zeros(tuple(input_size), dtype=torch.float32,
                            device=_device_of(net)))
    finally:
        for h in handles:
            h.remove()
        for m, was in modes:
            m.training = was
    total = sum(c[2] for c in counts)
    if print_detail:
        width = max((len(c[0]) for c in counts), default=20) + 2
        print(f"{'Layer':<{width}}{'Type':<18}{'FLOPs':>16}{'Params':>12}")
        for path, tname, fl, pr in counts:
            print(f"{path:<{width}}{tname:<18}{fl:>16,}{pr:>12,}")
        print(f"Total GFLOPs: {total / 1e9:.4f}")
        print(f"Total params: {sum(c[3] for c in counts):,}")
    return total


__all__ = ["Model", "summary", "flops"]
