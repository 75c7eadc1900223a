"""``paddle.audio`` (port of ``paddle_tpu/audio/__init__.py``): the
feature extractors ``Spectrogram``, ``MelSpectrogram``,
``LogMelSpectrogram`` and ``MFCC`` over :func:`paddle_tpu_torch.signal.stft`,
the tables of ``functional`` (mel scale, filterbank, DCT; numpy, the
reference's arithmetic), the cached ``TESS`` / ``ESC50`` datasets and
``load`` through the standard library's ``wave``.

The extractors run on their input's device; their tables (the window,
filterbank and DCT, float32) are made once on the host and copied to a
device at its first use. The windows are numpy's ``hanning`` /
``hamming``, which are symmetric (``torch.hann_window`` defaults to
periodic). ``LogMelSpectrogram``'s ``top_db`` clamps against the whole
tensor's maximum, not each item's, as the reference does. The datasets
and ``load`` are host code: they return numpy arrays and CPU tensors and
never touch CUDA, so they run in ``DataLoader`` workers.
"""
from __future__ import annotations

import math
import os
import types as _types

import numpy as np
import torch

from .. import signal as psignal
from .._cache import dataset_cache_path
from ..io import Dataset

__all__ = ["functional", "features", "Spectrogram", "MelSpectrogram",
           "LogMelSpectrogram", "MFCC", "datasets", "backends", "load"]


def hz_to_mel(f, htk=False):
    if htk:
        return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mel = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    safe = np.maximum(f, 1e-10)       # where() evaluates both branches
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(safe / min_log_hz) / logstep, mel)


def mel_to_hz(mel, htk=False):
    if htk:
        return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)
    mel = np.asarray(mel, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = math.log(6.4) / 27.0
    return np.where(mel >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mel - min_log_mel)), freqs)


def compute_fbank_matrix(sr, n_fft, n_mels=64, f_min=0.0, f_max=None,
                         htk=False, norm="slaney"):
    """The mel filterbank ``[n_mels, n_fft // 2 + 1]`` (float32 numpy)."""
    f_max = f_max or sr / 2
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, sr / 2, n_bins)
    mel_pts = np.linspace(hz_to_mel(f_min, htk), hz_to_mel(f_max, htk),
                          n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fb = np.zeros((n_mels, n_bins))
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[m] = np.clip(np.minimum(up, down), 0, None)
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2:] - hz_pts[:-2])
        fb *= enorm[:, None]
    return fb.astype(np.float32)


def create_dct(n_mfcc, n_mels, norm="ortho"):
    """The DCT-II matrix ``[n_mfcc, n_mels]`` (float32 numpy)."""
    n = np.arange(n_mels)
    k = np.arange(n_mfcc)[:, None]
    dct = np.cos(math.pi / n_mels * (n + 0.5) * k)
    if norm == "ortho":
        dct[0] *= 1.0 / math.sqrt(2)
        dct *= math.sqrt(2.0 / n_mels)
    return dct.astype(np.float32)


functional = _types.SimpleNamespace(
    hz_to_mel=hz_to_mel, mel_to_hz=mel_to_hz,
    compute_fbank_matrix=compute_fbank_matrix, create_dct=create_dct)


class _Table:
    """A float32 host table and its copies on the devices it was used
    on."""

    def __init__(self, array):
        self.host = torch.from_numpy(np.ascontiguousarray(array,
                                                          np.float32))
        self._on = {torch.device("cpu"): self.host}

    def on(self, device):
        if device not in self._on:
            self._on[device] = self.host.to(device)
        return self._on[device]


class Spectrogram:
    """The power spectrogram ``|stft(x)| ** power``:
    ``[..., n_fft // 2 + 1, frames]``."""

    def __init__(self, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect"):
        self.n_fft = n_fft
        self.hop_length = hop_length or n_fft // 4
        self.win_length = win_length or n_fft
        self.power = power
        self.center = center
        self.pad_mode = pad_mode
        w = np.hanning(self.win_length) if window == "hann" \
            else np.hamming(self.win_length) if window == "hamming" \
            else np.ones(self.win_length)
        self._window = _Table(w)

    @property
    def window(self):
        return self._window.host

    def __call__(self, x):
        sp = psignal.stft(x, self.n_fft, self.hop_length, self.win_length,
                          window=self._window.on(x.device),
                          center=self.center, pad_mode=self.pad_mode)
        return sp.abs() ** self.power


class MelSpectrogram(Spectrogram):
    """The spectrogram through the mel filterbank:
    ``[..., n_mels, frames]``."""

    def __init__(self, sr=22050, n_fft=512, hop_length=None, win_length=None,
                 window="hann", power=2.0, center=True, pad_mode="reflect",
                 n_mels=64, f_min=50.0, f_max=None, htk=False, norm="slaney"):
        super().__init__(n_fft, hop_length, win_length, window, power,
                         center, pad_mode)
        self._fbank = _Table(compute_fbank_matrix(sr, n_fft, n_mels, f_min,
                                                  f_max, htk, norm))

    @property
    def fbank(self):
        return self._fbank.host

    def __call__(self, x):
        spec = super().__call__(x)                    # [..., bins, frames]
        return torch.matmul(self._fbank.on(spec.device), spec)


class LogMelSpectrogram(MelSpectrogram):
    """The mel spectrogram in decibels: ``10 log10(max(m, amin))`` less
    ``10 log10(max(amin, ref_value))``, clamped to ``top_db`` below the
    whole tensor's maximum when given."""

    def __init__(self, *a, ref_value=1.0, amin=1e-10, top_db=None, **kw):
        super().__init__(*a, **kw)
        self.amin = amin
        self.ref_value = ref_value
        self.top_db = top_db

    def __call__(self, x):
        mel = super().__call__(x)
        db = 10.0 * torch.log10(torch.clamp(mel, min=self.amin))
        db = db - 10.0 * math.log10(max(self.amin, self.ref_value))
        if self.top_db is not None:
            db = torch.maximum(db, db.max() - self.top_db)
        return db


class MFCC:
    """The DCT of the log-mel spectrogram: ``[..., n_mfcc, frames]``."""

    def __init__(self, sr=22050, n_mfcc=40, n_mels=64, **kw):
        self.logmel = LogMelSpectrogram(sr=sr, n_mels=n_mels, **kw)
        self._dct = _Table(create_dct(n_mfcc, n_mels))

    @property
    def dct(self):
        return self._dct.host

    def __call__(self, x):
        lm = self.logmel(x)
        return torch.matmul(self._dct.on(lm.device), lm)


features = _types.SimpleNamespace(
    Spectrogram=Spectrogram, MelSpectrogram=MelSpectrogram,
    LogMelSpectrogram=LogMelSpectrogram, MFCC=MFCC)


class _CachedAudioDataset(Dataset):
    """Waveforms from a pre-extracted ``<name>_<mode>.npz``
    (``waveforms`` float32 ``[N, T]``, ``labels`` int64 ``[N]``) in the
    dataset cache, or ``data_file``; a miss raises ``IOError`` naming the
    path. ``feat_type="mfcc"`` gives each item's MFCC (computed on the
    CPU) instead of its waveform."""

    _name = None

    def __init__(self, mode="train", feat_type="raw", data_file=None,
                 sample_rate=16000, **kw):
        self.mode = mode
        self.feat_type = feat_type
        if data_file is None:
            data_file = dataset_cache_path(f"{self._name}_{mode}.npz")
        if not os.path.exists(data_file):
            raise IOError(f"{type(self).__name__}: nothing is downloaded: "
                          f"place the pre-extracted arrays at {data_file}")
        blob = np.load(data_file)
        self.waveforms = blob["waveforms"].astype(np.float32)
        self.labels = blob["labels"].astype(np.int64)
        self._mfcc = MFCC(sr=sample_rate) if feat_type == "mfcc" else None

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        wav = self.waveforms[i]
        if self._mfcc is not None:
            wav = self._mfcc(torch.from_numpy(wav[None])).numpy()[0]
        return wav, int(self.labels[i])


class TESS(_CachedAudioDataset):
    """The Toronto emotional speech set (``tess_<mode>.npz``)."""

    _name = "tess"


class ESC50(_CachedAudioDataset):
    """ESC-50 environmental sounds (``esc50_<mode>.npz``)."""

    _name = "esc50"


datasets = _types.SimpleNamespace(TESS=TESS, ESC50=ESC50)


def _load_wav(path, sr=None, mono=True, dtype="float32"):
    """A WAV file as ``([channels, frames] CPU tensor, rate)``: 16- and
    32-bit PCM scaled to [-1, 1), read with the standard library's
    ``wave``; ``mono`` averages the channels. No resampling: an ``sr``
    other than the file's raises."""
    import wave
    with wave.open(str(path), "rb") as w:
        nch, sw, rate, nframes = (w.getnchannels(), w.getsampwidth(),
                                  w.getframerate(), w.getnframes())
        raw = w.readframes(nframes)
    if sr is not None and int(sr) != rate:
        raise ValueError(
            f"audio.load: file is {rate} Hz but sr={sr} was requested — "
            "the wave backend does not resample; load at native rate and "
            "resample explicitly")
    if sw == 2:
        arr = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sw == 4:
        arr = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported WAV sample width {sw}")
    arr = arr.reshape(-1, nch).T
    if mono and nch > 1:
        arr = arr.mean(0, keepdims=True)
    return torch.from_numpy(np.ascontiguousarray(arr.astype(dtype))), rate


backends = _types.SimpleNamespace(
    list_available_backends=lambda: ["wave"],
    get_current_backend=lambda: "wave",
    set_backend=lambda name: None,
    load=_load_wav,
)
load = _load_wav
