"""The port's ``text`` (``paddle_tpu_torch/text/__init__.py``) against the
reference's (``paddle_tpu/text/__init__.py``) on the CPU:
``viterbi_decode`` with and without BOS/EOS tags, ragged lengths and
ties (paths equal exactly, scores within 1e-5 of their largest
magnitude); ``UCIHousing``'s synthetic mode and file mode, ``Imikolov``
and ``Movielens`` on archives written here in the cache layout under a
``tmp_path`` ``HOME``."""
import io
import tarfile
import zipfile

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import text as jtext

from paddle_tpu_torch import text as ttext
from torch_zoo_common import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _setup(one_torch_thread):  # noqa: F811
    yield


def _decode_both(emis, trans, lens, bos):
    js, jp = jtext.viterbi_decode(
        paddle.to_tensor(emis), paddle.to_tensor(trans),
        None if lens is None else paddle.to_tensor(lens), bos)
    ts, tp = ttext.viterbi_decode(
        torch.from_numpy(emis), torch.from_numpy(trans),
        None if lens is None else torch.from_numpy(lens), bos)
    assert tp.dtype == torch.int64
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp.numpy()))
    js = np.asarray(js.numpy())
    assert ts.shape == js.shape
    assert float(np.abs(ts.numpy() - js).max()) <= 1e-5 * float(
        np.abs(js).max())
    return ts, tp


@pytest.mark.parametrize("bos", [True, False])
@pytest.mark.parametrize("ragged", [True, False])
def test_viterbi_matches_reference(bos, ragged):
    rng = np.random.default_rng(1)
    b, t, n = 6, 12, 5
    emis = rng.standard_normal((b, t, n)).astype(np.float32)
    trans = rng.standard_normal((n + 2, n + 2) if bos else (n, n)).astype(
        np.float32)
    lens = np.array([12, 1, 5, 7, 12, 3], np.int64) if ragged else None
    _decode_both(emis, trans, lens, bos)
    decoder = ttext.ViterbiDecoder(torch.from_numpy(trans), bos)
    _, path = decoder(torch.from_numpy(emis),
                      None if lens is None else torch.from_numpy(lens))
    assert tuple(path.shape) == (b, t)


def test_viterbi_ties_take_the_first_index():
    """Integer-valued scores with many exact ties: the first maximal tag
    wins in both packages."""
    rng = np.random.default_rng(2)
    emis = rng.integers(0, 2, (4, 9, 4)).astype(np.float32)
    trans = rng.integers(0, 2, (6, 6)).astype(np.float32)
    lens = np.array([9, 4, 1, 6], np.int64)
    _decode_both(emis, trans, lens, True)
    zeros = np.zeros((2, 5, 3), np.float32)
    _, path = _decode_both(zeros, np.zeros((3, 3), np.float32), None, False)
    assert not path.any()


def test_uci_housing(tmp_path, monkeypatch):
    for mode in ("train", "test"):
        got = ttext.UCIHousing(mode=mode, synthetic=7)
        want = jtext.UCIHousing(mode=mode, synthetic=7)
        assert len(got) == len(want) == 7
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(IOError, match="housing.data"):
        ttext.UCIHousing()
    root = tmp_path / ".cache" / "paddle" / "dataset"
    root.mkdir(parents=True)
    rows = np.random.default_rng(3).random((20, 14)) * 10
    np.savetxt(root / "housing.data", rows)
    for mode in ("train", "test"):
        got, want = ttext.UCIHousing(mode=mode), jtext.UCIHousing(mode=mode)
        assert len(got) == len(want) == (16 if mode == "train" else 4)
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def _tar_add(tf, name, text):
    data = text.encode()
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def test_imikolov_and_movielens(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    root = tmp_path / ".cache" / "paddle" / "dataset"
    root.mkdir(parents=True)
    with tarfile.open(root / "simple-examples.tgz", "w:gz") as tf:
        _tar_add(tf, "./simple-examples/data/ptb.train.txt",
                 "the cat sat on the mat\na dog ran\nthe dog sat down now\n")
        _tar_add(tf, "./simple-examples/data/ptb.test.txt",
                 "the bird sat\na cat ran on the mat today\n")
    for mode in ("train", "test"):
        for kind, kw in (("NGRAM", dict(window_size=3)), ("SEQ", {})):
            got = ttext.Imikolov(data_type=kind, mode=mode, **kw)
            want = jtext.Imikolov(data_type=kind, mode=mode, **kw)
            assert got.word_idx == want.word_idx
            assert list(got) == list(want) and len(got) > 0
    with zipfile.ZipFile(root / "ml-1m.zip", "w") as z:
        z.writestr("ml-1m/users.dat", "1::M::25::4::10001\n2::F::1::9::2\n")
        z.writestr("ml-1m/movies.dat",
                   "10::Toy Story (1995)::Animation|Comedy\n"
                   "20::Heat (1995)::Action|Crime|Thriller\n")
        z.writestr("ml-1m/ratings.dat", "".join(
            f"{1 + i % 2}::{10 * (1 + i % 3 // 2)}::{1 + i % 5}::{i}\n"
            for i in range(23)))
    for mode in ("train", "test"):
        got, want = ttext.Movielens(mode=mode), jtext.Movielens(mode=mode)
        assert list(got) == list(want) and len(got) > 0
        assert got.categories_dict == want.categories_dict
    with pytest.raises(IOError, match="wmt14.tgz"):
        ttext.WMT14()
