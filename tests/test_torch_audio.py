"""The port's ``audio`` (``paddle_tpu_torch/audio/__init__.py``) against
the reference's (``paddle_tpu/audio/__init__.py``) on the CPU: the mel
scale, the filterbank and the DCT table equal bit for bit (numpy on both
sides); ``Spectrogram``, ``MelSpectrogram``, ``LogMelSpectrogram`` (with
and without ``top_db``) and ``MFCC`` within 1e-5 of each output's
largest magnitude (the FFTs sum in different orders, pocketfft against
XLA); ``load`` of a WAV file written here; the cached datasets."""
import wave

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import audio as jaudio

from paddle_tpu_torch import audio as taudio
from torch_zoo_common import one_torch_thread  # noqa: F401

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread):  # noqa: F811
    yield


def _err(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want.numpy())
    assert got.shape == want.shape and got.dtype == want.dtype
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("htk", [False, True])
def test_tables_equal_the_references(htk):
    f = np.linspace(0, 11025, 97)
    np.testing.assert_array_equal(taudio.hz_to_mel(f, htk),
                                  jaudio.hz_to_mel(f, htk))
    m = np.linspace(0, 3000 if htk else 60, 41)
    np.testing.assert_array_equal(taudio.mel_to_hz(m, htk),
                                  jaudio.mel_to_hz(m, htk))
    for args in ((16000, 512, 80, 0.0, None), (22050, 400, 64, 50.0, 8000)):
        np.testing.assert_array_equal(
            taudio.functional.compute_fbank_matrix(*args, htk=htk),
            jaudio.functional.compute_fbank_matrix(*args, htk=htk))
    for norm in ("ortho", None):
        np.testing.assert_array_equal(
            taudio.functional.create_dct(40, 80, norm),
            jaudio.functional.create_dct(40, 80, norm))


CASES = [
    ("Spectrogram", dict(n_fft=256, hop_length=80)),
    ("Spectrogram", dict(n_fft=128, window="hamming", power=1.0,
                         pad_mode="constant")),
    ("MelSpectrogram", dict(sr=16000, n_fft=256, hop_length=80, n_mels=40)),
    ("LogMelSpectrogram", dict(sr=16000, n_fft=256, hop_length=80,
                               n_mels=40)),
    ("LogMelSpectrogram", dict(sr=16000, n_fft=256, n_mels=32, top_db=40.0,
                               ref_value=2.0)),
    ("MFCC", dict(sr=16000, n_mfcc=20, n_mels=40, n_fft=256,
                  hop_length=80)),
]


@pytest.mark.parametrize("name,kw", CASES, ids=[
    f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_features_match_reference(name, kw):
    clips = np.random.default_rng(1).standard_normal((3, 4000)).astype(
        np.float32) * 0.3
    got = getattr(taudio, name)(**kw)(torch.from_numpy(clips))
    want = getattr(jaudio, name)(**kw)(paddle.to_tensor(clips))
    err = _err(got, want)
    print(f"{name} {kw}: worst error {err:.3g} of the largest magnitude")
    assert err <= TOL


def test_top_db_clamps_against_the_whole_tensor():
    """A quiet clip beside a loud one: the quiet clip's floor is the loud
    clip's maximum less ``top_db``, as the reference clamps."""
    rng = np.random.default_rng(2)
    clips = np.stack([rng.standard_normal(2000), 1e-3 * rng.standard_normal(
        2000)]).astype(np.float32)
    kw = dict(sr=16000, n_fft=128, n_mels=16, top_db=30.0)
    got = taudio.LogMelSpectrogram(**kw)(torch.from_numpy(clips))
    floor = got.max() - 30.0
    # the quiet clip lies ~60 dB down: all of it sits on the loud clip's
    # floor, where a clamp per item would have kept its own shape
    assert torch.equal(got[1], floor.expand_as(got[1]))
    assert _err(got, jaudio.LogMelSpectrogram(**kw)(
        paddle.to_tensor(clips))) <= TOL


@pytest.mark.parametrize("width,channels", [(2, 1), (2, 2), (4, 1)])
def test_load_wav(tmp_path, width, channels):
    rng = np.random.default_rng(3)
    dtype = {2: np.int16, 4: np.int32}[width]
    info = np.iinfo(dtype)
    pcm = rng.integers(info.min, info.max, (500, channels), dtype=dtype)
    path = tmp_path / "clip.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    for mono in (True, False):
        got, sr = taudio.load(path, mono=mono)
        want, jsr = jaudio.load(path, mono=mono)
        assert sr == jsr == 16000 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want.numpy()))
    with pytest.raises(ValueError):
        taudio.load(path, sr=8000)


def test_cached_datasets(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(IOError, match="tess_train.npz"):
        taudio.datasets.TESS()
    root = tmp_path / ".cache" / "paddle" / "dataset"
    root.mkdir(parents=True)
    rng = np.random.default_rng(4)
    np.savez(root / "esc50_train.npz",
             waveforms=rng.standard_normal((3, 3000)).astype(np.float32),
             labels=np.array([4, 1, 7]))
    raw = taudio.ESC50()
    assert len(raw) == 3 and raw[1][1] == 1
    np.testing.assert_array_equal(raw[2][0], jaudio.ESC50()[2][0])
    got = taudio.ESC50(feat_type="mfcc")[0][0]
    want = np.asarray(jaudio.ESC50(feat_type="mfcc")[0][0])
    assert got.shape == want.shape
    assert float(np.abs(got - want).max() / np.abs(want).max()) <= TOL
