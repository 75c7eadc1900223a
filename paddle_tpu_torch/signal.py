"""``paddle.signal`` (port of ``paddle_tpu/signal.py``): ``frame``,
``overlap_add``, ``stft`` and ``istft`` on ``torch.fft``, differentiable
through autograd (``stft``'s gradient included).

Framing is ``unfold`` / ``index_select``; the overlap-add of
``overlap_add`` and ``istft`` is one ``fold`` (col2im) over every frame,
not a launch a frame. ``istft`` divides by the window envelope clamped to
``1e-10``, as the reference does, and so never raises where the envelope
vanishes (``torch.istft`` would, on its NOLA check). With ``center``,
``stft`` pads by ``n_fft // 2`` on each side: ``"reflect"`` leaves the
edge sample out in ``torch.nn.functional.pad`` as in ``jnp.pad``;
``"edge"`` and ``"wrap"`` are jnp's names for ``"replicate"`` and
``"circular"``.
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from .ops._util import as_tensor

__all__ = ["frame", "overlap_add", "stft", "istft"]

_PAD_MODES = {"reflect": "reflect", "constant": "constant",
              "edge": "replicate", "replicate": "replicate",
              "wrap": "circular", "circular": "circular"}


def frame(x, frame_length, hop_length, axis=-1, name=None):
    """Overlapping frames: ``[..., seq]`` -> ``[..., frame_length, n]``
    (for ``axis=-1``; the reference's ``take`` layout, frames placed at
    ``axis`` and the last two axes swapped)."""
    a = as_tensor(x)
    ax = axis % a.ndim
    n = (a.shape[ax] - frame_length) // hop_length + 1
    starts = torch.arange(n, device=a.device) * hop_length
    idx = starts[:, None] + torch.arange(frame_length, device=a.device)
    out = a.index_select(ax, idx.reshape(-1)).reshape(
        a.shape[:ax] + (n, frame_length) + a.shape[ax + 1:])
    return out.transpose(-1, -2)


def _ola(frames, hop):
    """``[..., fl, n]`` -> ``[..., (n - 1) hop + fl]``: frame ``i`` added
    at ``i * hop``, in one ``fold``."""
    if frames.is_complex():
        parts = _ola(torch.view_as_real(frames).movedim(-1, 0), hop)
        return torch.complex(parts[0], parts[1])
    if not frames.is_floating_point():
        return _ola(frames.double(), hop).to(frames.dtype)
    fl, n = frames.shape[-2:]
    seq = (n - 1) * hop + fl
    out = F.fold(frames.reshape(-1, fl, n), output_size=(1, seq),
                 kernel_size=(1, fl), stride=(1, hop))
    return out.reshape(frames.shape[:-2] + (seq,))


def overlap_add(x, hop_length, axis=-1, name=None):
    """The inverse of :func:`frame`: ``[..., frame_length, n]`` ->
    ``[..., seq]``, overlapping samples summed."""
    return _ola(as_tensor(x), hop_length)


def _window(window, n_fft, win_length, like):
    win = as_tensor(window, like).to(like.device)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = F.pad(win, (lpad, n_fft - win_length - lpad))
    return win


def stft(x, n_fft, hop_length=None, win_length=None, window=None,
         center=True, pad_mode="reflect", normalized=False, onesided=True,
         name=None):
    """Short-time Fourier transform: ``[..., seq]`` ->
    ``[..., n_fft // 2 + 1, frames]`` complex (``onesided``; ``n_fft``
    bins otherwise)."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    a = as_tensor(x)
    if center:
        half = n_fft // 2
        if pad_mode not in _PAD_MODES:
            raise ValueError(f"stft: pad_mode {pad_mode!r} is not one of "
                             f"{sorted(_PAD_MODES)}")
        flat = a.reshape((-1, 1, a.shape[-1]))
        a = F.pad(flat, (half, half), mode=_PAD_MODES[pad_mode]).reshape(
            a.shape[:-1] + (a.shape[-1] + 2 * half,))
    frames = a.unfold(-1, n_fft, hop_length)          # [..., n, n_fft]
    if window is not None:
        frames = frames * _window(window, n_fft, win_length, a)
    sp = (torch.fft.rfft(frames, dim=-1) if onesided
          else torch.fft.fft(frames, dim=-1))
    if normalized:
        sp = sp / torch.sqrt(torch.tensor(float(n_fft), dtype=sp.real.dtype,
                                          device=sp.device))
    return sp.transpose(-1, -2)


def istft(x, n_fft, hop_length=None, win_length=None, window=None,
          center=True, normalized=False, onesided=True, length=None,
          return_complex=False, name=None):
    """The inverse of :func:`stft`: inverse FFTs of the frames, windowed,
    overlap-added and divided by the summed squared window (at least
    ``1e-10``); ``center`` trims ``n_fft // 2`` from each end, ``length``
    cuts the result."""
    hop_length = hop_length or n_fft // 4
    win_length = win_length or n_fft
    sp_t = as_tensor(x).transpose(-1, -2)             # [..., n, bins]
    if normalized:
        sp_t = sp_t * torch.sqrt(torch.tensor(
            float(n_fft), dtype=sp_t.real.dtype, device=sp_t.device))
    frames = (torch.fft.irfft(sp_t, n=n_fft, dim=-1) if onesided
              else torch.fft.ifft(sp_t, dim=-1).real)
    win = (_window(window, n_fft, win_length, frames) if window is not None
           else torch.ones(n_fft, dtype=frames.dtype, device=frames.device))
    frames = frames * win
    n = frames.shape[-2]
    num = _ola(frames.transpose(-1, -2), hop_length)
    den = _ola((win * win)[:, None].expand(n_fft, n), hop_length)
    out = num / torch.clamp(den, min=1e-10)
    if center:
        out = out[..., n_fft // 2: out.shape[-1] - n_fft // 2]
    if length is not None:
        out = out[..., :length]
    return out
