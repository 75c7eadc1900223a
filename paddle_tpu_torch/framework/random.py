"""Paddle's global RNG over one explicit ``torch.Generator`` per device.

``seed(s)`` reseeds every generator made so far, and generators made
later start from ``s``; the port's random ops draw only from
:func:`generator` of their device, never from torch's global RNG. Streams
reproduce within the port; they are not the reference's JAX key streams
(ROADMAP C2)."""
from __future__ import annotations

import threading

import numpy as np
import torch

_lock = threading.Lock()
_seed = int(np.random.randint(0, 2**31 - 1))
_generators = {}          # torch.device -> torch.Generator


def _key(device):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def generator(device="cpu"):
    """The generator of ``device``, made (and seeded) at its first use."""
    dev = _key(device)
    with _lock:
        gen = _generators.get(dev)
        if gen is None:
            gen = _generators[dev] = torch.Generator(device=dev)
            gen.manual_seed(_seed)
        return gen


def seed(s):
    """paddle.seed: reseed every device's generator; returns the generator
    of the current device."""
    global _seed
    with _lock:
        _seed = int(s)
        for gen in _generators.values():
            gen.manual_seed(_seed)
    return default_generator()


def default_generator():
    from .core import current_device
    return generator(current_device())


def get_rng_state():
    """The current device's generator state, as a one-element list."""
    return [default_generator().get_state()]


def set_rng_state(state):
    if isinstance(state, (list, tuple)):
        state = state[0]
    default_generator().set_state(state)


def _cuda_devices():
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def get_cuda_rng_state():
    """The state of every CUDA device's generator, in device order."""
    return [generator(d).get_state() for d in _cuda_devices()]


def set_cuda_rng_state(state):
    for d, s in zip(_cuda_devices(), state):
        generator(d).set_state(s)
