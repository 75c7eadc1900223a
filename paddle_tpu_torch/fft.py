"""``paddle.fft`` (port of ``paddle_tpu/fft.py``): the discrete Fourier
transforms on ``torch.fft`` (cuFFT on the card, pocketfft on the CPU),
differentiable through autograd.

The reference's transforms are XLA's FFT, not Pallas kernels, so the
port has no kernel of its own here. ``norm`` is ``"backward"``,
``"forward"``, ``"ortho"`` or None (``"backward"``). ``hfft2`` /
``ihfft2`` / ``hfftn`` / ``ihfftn`` are the reference's own composition
(a plain FFT over the leading axes, the Hermitian one on the last), not
``torch.fft.hfftn``. A non-tensor input lands on the current device, as
``to_tensor`` puts it; 64-bit inputs stay 64-bit (ROADMAP C26).
"""
from __future__ import annotations

import torch

from .framework import dtype as dtypes
from .framework.core import current_device
from .ops._util import as_tensor

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
    "fft2", "ifft2", "rfft2", "irfft2", "hfft2", "ihfft2",
    "fftn", "ifftn", "rfftn", "irfftn", "hfftn", "ihfftn",
    "fftfreq", "rfftfreq", "fftshift", "ifftshift",
]


def _norm(norm):
    return {"backward": "backward", "forward": "forward", "ortho": "ortho",
            None: "backward"}[norm]


def _dims(axes):
    if axes is None or isinstance(axes, int):
        return axes
    return tuple(axes)


def _sizes(s):
    return None if s is None else tuple(s)


def _wrap1(tfn, name):
    def op(x, n=None, axis=-1, norm="backward", name=None):
        return tfn(as_tensor(x), n=n, dim=axis, norm=_norm(norm))
    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"``paddle.fft.{name}`` along ``axis``."
    return op


def _wrapn(tfn, name, axes_default=None):
    def op(x, s=None, axes=axes_default, norm="backward", name=None):
        return tfn(as_tensor(x), s=_sizes(s), dim=_dims(axes),
                   norm=_norm(norm))
    op.__name__ = op.__qualname__ = name
    op.__doc__ = f"``paddle.fft.{name}`` over ``axes``."
    return op


fft = _wrap1(torch.fft.fft, "fft")
ifft = _wrap1(torch.fft.ifft, "ifft")
rfft = _wrap1(torch.fft.rfft, "rfft")
irfft = _wrap1(torch.fft.irfft, "irfft")
hfft = _wrap1(torch.fft.hfft, "hfft")
# torch's ihfft returns a lazily conjugated view; the port's is resolved
ihfft = _wrap1(lambda *a, **k: torch.fft.ihfft(*a, **k).resolve_conj(),
               "ihfft")

fft2 = _wrapn(torch.fft.fft2, "fft2", (-2, -1))
ifft2 = _wrapn(torch.fft.ifft2, "ifft2", (-2, -1))
rfft2 = _wrapn(torch.fft.rfft2, "rfft2", (-2, -1))
irfft2 = _wrapn(torch.fft.irfft2, "irfft2", (-2, -1))
fftn = _wrapn(torch.fft.fftn, "fftn")
ifftn = _wrapn(torch.fft.ifftn, "ifftn")
rfftn = _wrapn(torch.fft.rfftn, "rfftn")
irfftn = _wrapn(torch.fft.irfftn, "irfftn")


def _hfftn_impl(a, s, axes, norm):
    """The Hermitian FFT over several axes: a plain FFT over the leading
    axes, then the Hermitian (real-output) one on the last."""
    lead, last = axes[:-1], axes[-1]
    n_last = None if s is None else s[-1]
    if lead:
        a = torch.fft.fftn(a, s=None if s is None else tuple(s[:-1]),
                           dim=lead, norm=norm)
    return torch.fft.hfft(a, n=n_last, dim=last, norm=norm)


def _ihfftn_impl(a, s, axes, norm):
    lead, last = axes[:-1], axes[-1]
    n_last = None if s is None else s[-1]
    out = torch.fft.ihfft(a, n=n_last, dim=last, norm=norm).resolve_conj()
    if lead:
        out = torch.fft.ifftn(out, s=None if s is None else tuple(s[:-1]),
                              dim=lead, norm=norm)
    return out


def _default_axes(a, s, axes):
    if axes is not None:
        return tuple(axes)
    # with s given, the last len(s) axes
    return tuple(range(a.ndim - len(s), a.ndim)) if s is not None \
        else tuple(range(a.ndim))


def hfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """2-D FFT of a Hermitian-symmetric signal (real output)."""
    return _hfftn_impl(as_tensor(x), s, tuple(axes), _norm(norm))


def ihfft2(x, s=None, axes=(-2, -1), norm="backward", name=None):
    """Inverse of :func:`hfft2` (Hermitian output)."""
    return _ihfftn_impl(as_tensor(x), s, tuple(axes), _norm(norm))


def hfftn(x, s=None, axes=None, norm="backward", name=None):
    """N-D Hermitian FFT (real output)."""
    a = as_tensor(x)
    return _hfftn_impl(a, s, _default_axes(a, s, axes), _norm(norm))


def ihfftn(x, s=None, axes=None, norm="backward", name=None):
    """Inverse of :func:`hfftn`."""
    a = as_tensor(x)
    return _ihfftn_impl(a, s, _default_axes(a, s, axes), _norm(norm))


def _freq_dtype(dtype):
    return dtypes.convert_dtype(dtype) if dtype is not None \
        else torch.float32


def fftfreq(n, d=1.0, dtype=None, name=None):
    """Sample frequencies ``[0, 1, ..., -1] / (n d)`` on the current
    device, float32 unless ``dtype`` says otherwise."""
    return torch.fft.fftfreq(n, d, dtype=_freq_dtype(dtype),
                             device=current_device())


def rfftfreq(n, d=1.0, dtype=None, name=None):
    """The non-negative frequencies of :func:`fftfreq` (``rfft``'s)."""
    return torch.fft.rfftfreq(n, d, dtype=_freq_dtype(dtype),
                              device=current_device())


def fftshift(x, axes=None, name=None):
    return torch.fft.fftshift(as_tensor(x), dim=_dims(axes))


def ifftshift(x, axes=None, name=None):
    return torch.fft.ifftshift(as_tensor(x), dim=_dims(axes))
