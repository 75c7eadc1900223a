"""The port's ``fft`` and ``signal`` (``paddle_tpu_torch/{fft,signal}.py``)
against the reference's (``paddle_tpu/{fft,signal}.py``) on the CPU: the
22 ``fft`` functions for each ``norm``, with and without ``n`` / ``s`` /
``axes``; ``frame``, ``overlap_add``, ``stft`` (its options and its
gradient) and ``istft``.

The rule: every output within 1e-5 of its largest magnitude, fp32 on
both sides. pocketfft (torch) and XLA's FFT sum in different orders, so
elements near zero carry the rounding of the whole transform's scale;
the worst error of each case is logged (``-s``)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import fft as jfft
from paddle_tpu import signal as jsignal

from paddle_tpu_torch import fft as tfft
from paddle_tpu_torch import signal as tsignal
from torch_vision_common import port_on_cpu  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _setup(port_on_cpu):  # noqa: F811
    yield


def _arrays(seed, shape=(3, 6, 8)):
    rng = np.random.default_rng(seed)
    real = rng.standard_normal(shape).astype(np.float32)
    cplx = (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return real, cplx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x.numpy())


def check(got, want, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.complex128)
                       - want.astype(np.complex128)).max()) / scale
    print(f"{what}: worst error {err:.3g} of the largest magnitude")
    assert err <= TOL, (what, err)


#: (function, takes a complex input, extra keyword sets)
ONE_D = [("fft", True), ("ifft", True), ("rfft", False), ("irfft", True),
         ("hfft", True), ("ihfft", False)]
N_D = [("fft2", True), ("ifft2", True), ("rfft2", False), ("irfft2", True),
       ("hfft2", True), ("ihfft2", False), ("fftn", True), ("ifftn", True),
       ("rfftn", False), ("irfftn", True), ("hfftn", True),
       ("ihfftn", False)]
NORMS = ["backward", "forward", "ortho"]


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name,cplx", ONE_D, ids=[n for n, _ in ONE_D])
def test_one_dimensional(name, cplx, norm):
    real, c = _arrays(1)
    x = c if cplx else real
    kws = [{}]
    if norm == "backward":
        kws += [{"n": 5, "axis": 1}, {"n": 11, "axis": 0}]
    for kw in kws:
        check(getattr(tfft, name)(torch.from_numpy(x), norm=norm, **kw),
              getattr(jfft, name)(paddle.to_tensor(x), norm=norm, **kw),
              f"{name} {norm} {kw}")


@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("name,cplx", N_D, ids=[n for n, _ in N_D])
def test_multi_dimensional(name, cplx, norm):
    real, c = _arrays(2)
    x = c if cplx else real
    kws = [{}]
    if norm == "backward":
        kws += [{"s": (4, 6)}, {"axes": (0, 2)}, {"s": (5, 7), "axes": (2, 0)}]
    for kw in kws:
        check(getattr(tfft, name)(torch.from_numpy(x), norm=norm, **kw),
              getattr(jfft, name)(paddle.to_tensor(x), norm=norm, **kw),
              f"{name} {norm} {kw}")


def test_frequencies_and_shifts():
    for name in ("fftfreq", "rfftfreq"):
        for n, d in ((9, 1.0), (10, 0.25)):
            check(getattr(tfft, name)(n, d), getattr(jfft, name)(n, d),
                  f"{name} {n} {d}")
    real, c = _arrays(3)
    for name in ("fftshift", "ifftshift"):
        for x in (real, c):
            for axes in (None, (1,), 2):
                check(getattr(tfft, name)(torch.from_numpy(x), axes=axes),
                      getattr(jfft, name)(paddle.to_tensor(x), axes=axes),
                      f"{name} {axes}")


def test_fft_gradient():
    real, _ = _arrays(4)
    cot = np.random.default_rng(5).standard_normal((3, 6, 5)).astype(
        np.float32)
    jx = paddle.to_tensor(real, stop_gradient=False)
    (paddle.abs(jfft.rfft(jx, norm="ortho")) * paddle.to_tensor(cot)).sum() \
        .backward()
    tx = torch.from_numpy(real).requires_grad_()
    (tfft.rfft(tx, norm="ortho").abs() * torch.from_numpy(cot)).sum() \
        .backward()
    check(tx.grad, jx.grad, "rfft gradient")


def test_frame_and_overlap_add():
    real, c = _arrays(6, (2, 3, 40))
    for x in (real, c):
        for fl, hop in ((8, 4), (10, 3), (5, 5)):
            tf = tsignal.frame(torch.from_numpy(x), fl, hop)
            check(tf, jsignal.frame(paddle.to_tensor(x), fl, hop),
                  f"frame {fl} {hop}")
            check(tsignal.overlap_add(tf, hop),
                  jsignal.overlap_add(jsignal.frame(paddle.to_tensor(x), fl,
                                                    hop), hop),
                  f"overlap_add {fl} {hop}")
    x = real[0]                                         # [3, 40], axis 0
    check(tsignal.frame(torch.from_numpy(x.T.copy()), 4, 2, axis=0),
          jsignal.frame(paddle.to_tensor(x.T.copy()), 4, 2, axis=0),
          "frame axis 0")


STFT_CASES = [
    dict(n_fft=32, hop_length=8, win_length=24, window="hann",
         normalized=True),
    dict(n_fft=16, window=None, center=False),
    dict(n_fft=32, hop_length=16, window="hamming", pad_mode="constant",
         onesided=False),
]


def _window(case):
    w = case.get("window")
    if w is None:
        return None
    n = case.get("win_length", case["n_fft"])
    return (np.hanning(n) if w == "hann" else np.hamming(n)).astype(
        np.float32)


@pytest.mark.parametrize("case", STFT_CASES, ids=range(len(STFT_CASES)))
def test_stft_istft_and_gradient(case):
    real, _ = _arrays(7, (2, 200))
    win = _window(case)
    kw = {k: v for k, v in case.items() if k not in ("n_fft", "window")}
    jx = paddle.to_tensor(real, stop_gradient=False)
    tx = torch.from_numpy(real).requires_grad_()
    jw = None if win is None else paddle.to_tensor(win)
    tw = None if win is None else torch.from_numpy(win)
    jsp = jsignal.stft(jx, case["n_fft"], window=jw, **kw)
    tsp = tsignal.stft(tx, case["n_fft"], window=tw, **kw)
    check(tsp, jsp, f"stft {case}")
    cot = np.random.default_rng(8).standard_normal(
        tuple(tsp.shape)).astype(np.float32)
    (paddle.abs(jsp) * paddle.to_tensor(cot)).sum().backward()
    (tsp.abs() * torch.from_numpy(cot)).sum().backward()
    check(tx.grad, jx.grad, f"stft gradient {case}")
    ikw = {k: v for k, v in kw.items() if k != "pad_mode"}
    for length in (None, 150):
        check(tsignal.istft(tsp.detach(), case["n_fft"], window=tw,
                            length=length, **ikw),
              jsignal.istft(jsp.detach(), case["n_fft"], window=jw,
                            length=length, **ikw),
              f"istft {case} {length}")


def test_istft_envelope_floor():
    """A window that vanishes on the frames' edges with ``center=False``:
    the envelope is 0 at the ends, and both divide by ``1e-10`` there
    instead of raising."""
    real, _ = _arrays(9, (1, 64))
    win = np.hanning(16).astype(np.float32)
    jsp = jsignal.stft(paddle.to_tensor(real), 16, 4,
                       window=paddle.to_tensor(win), center=False)
    tsp = tsignal.stft(torch.from_numpy(real), 16, 4,
                       window=torch.from_numpy(win), center=False)
    check(tsignal.istft(tsp, 16, 4, window=torch.from_numpy(win),
                        center=False),
          jsignal.istft(jsp, 16, 4, window=paddle.to_tensor(win),
                        center=False), "istft at a vanishing envelope")


def test_float64_stays_float64():
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 64)))
    assert tfft.rfft(x).dtype == torch.complex128
    assert tsignal.stft(x, 16).dtype == torch.complex128
    assert tsignal.istft(tsignal.stft(x, 16), 16).dtype == torch.float64
