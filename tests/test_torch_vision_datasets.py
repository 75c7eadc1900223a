"""The port's ``vision.datasets`` (``paddle_tpu_torch/vision/datasets``)
against the reference's (``paddle_tpu/vision/datasets``) on files
written here in the cache layout under a ``tmp_path`` ``HOME``:
``FakeData``'s draws, ``Cifar10`` / ``Cifar100`` (the pickled-batch
tarballs, and the extracted directory), ``MNIST`` / ``FashionMNIST``
(idx ``.gz``), ``FlowersArrays`` and ``VOC2012``; items equal, with and
without a transform, and the misses raise naming the path."""
import gzip
import io
import pickle
import tarfile

import numpy as np
import pytest

from paddle_tpu.vision import datasets as jds
from paddle_tpu.vision import transforms as jtr

from paddle_tpu_torch import io as tio
from paddle_tpu_torch.vision import datasets as tds
from paddle_tpu_torch.vision import transforms as ttr


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A ``HOME`` of the test's own; the reference's import-time root
    pointed at it too."""
    monkeypatch.setenv("HOME", str(tmp_path))
    root = tmp_path / ".cache" / "paddle" / "dataset"
    root.mkdir(parents=True)
    monkeypatch.setattr(jds, "_DEFAULT_ROOT", str(root))
    return root


def _items_equal(got, want, n=None):
    assert len(got) == len(want)
    for i in range(len(got) if n is None else n):
        (gx, gy), (wx, wy) = got[i], want[i]
        np.testing.assert_array_equal(np.asarray(gx), np.asarray(wx))
        assert gy == wy if np.isscalar(gy) else np.array_equal(gy, wy)


def test_fake_data():
    for seed in (0, 5):
        got = tds.FakeData(size=9, image_shape=(3, 8, 6), num_classes=4,
                           seed=seed)
        want = jds.FakeData(size=9, image_shape=(3, 8, 6), num_classes=4,
                            seed=seed)
        assert isinstance(got, tio.Dataset)
        _items_equal(got, want)


def _tar_bytes(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _cifar_batch(rng, n, fine=False):
    d = {b"data": rng.integers(0, 256, (n, 3072), dtype=np.uint8)}
    d[b"fine_labels" if fine else b"labels"] = \
        rng.integers(0, 100 if fine else 10, n).tolist()
    return pickle.dumps(d)


def test_cifar(cache):
    with pytest.raises(FileNotFoundError, match="cifar-10-python.tar.gz"):
        tds.Cifar10()
    rng = np.random.default_rng(1)
    (cache / "cifar").mkdir()
    with tarfile.open(cache / "cifar" / "cifar-10-python.tar.gz",
                      "w:gz") as tf:
        for name in [f"data_batch_{i}" for i in range(1, 6)] + [
                "test_batch"]:
            _tar_bytes(tf, f"cifar-10-batches-py/{name}",
                       _cifar_batch(rng, 4))
    with tarfile.open(cache / "cifar" / "cifar-100-python.tar.gz",
                      "w:gz") as tf:
        for name in ("train", "test"):
            _tar_bytes(tf, f"cifar-100-python/{name}",
                       _cifar_batch(rng, 5, fine=True))
    for mode in ("train", "test"):
        _items_equal(tds.Cifar10(mode=mode), jds.Cifar10(mode=mode))
        _items_equal(tds.Cifar100(mode=mode), jds.Cifar100(mode=mode))
    np.random.seed(3)
    got = tds.Cifar10(transform=ttr.Compose([
        ttr.RandomCrop(32, padding=4), ttr.RandomHorizontalFlip(),
        ttr.Normalize([125.3, 123.0, 113.9], [63.0, 62.1, 66.7],
                      data_format="HWC"), ttr.Transpose()]))
    items = [got[i] for i in range(6)]
    np.random.seed(3)
    want = jds.Cifar10(transform=jtr.Compose([
        jtr.RandomCrop(32, padding=4), jtr.RandomHorizontalFlip(),
        jtr.Normalize([125.3, 123.0, 113.9], [63.0, 62.1, 66.7],
                      data_format="HWC"), jtr.Transpose()]))
    for (gx, gy), i in zip(items, range(6)):
        wx, wy = want[i]
        assert gy == wy and gx.shape == (3, 32, 32)
        np.testing.assert_array_equal(gx, wx)


def _idx(data, magic, dims):
    head = magic.to_bytes(4, "big") + b"".join(
        d.to_bytes(4, "big") for d in dims)
    return gzip.compress(head + data.tobytes())


def test_mnist(cache):
    with pytest.raises(FileNotFoundError, match="mnist"):
        tds.MNIST()
    rng = np.random.default_rng(2)
    (cache / "mnist").mkdir()
    for prefix, n in (("train", 6), ("t10k", 3)):
        imgs = rng.integers(0, 256, (n, 28, 28), dtype=np.uint8)
        labels = rng.integers(0, 10, n, dtype=np.uint8)
        (cache / "mnist" / f"{prefix}-images-idx3-ubyte.gz").write_bytes(
            _idx(imgs, 2051, (n, 28, 28)))
        (cache / "mnist" / f"{prefix}-labels-idx1-ubyte.gz").write_bytes(
            _idx(labels, 2049, (n,)))
    for mode in ("train", "test"):
        _items_equal(tds.MNIST(mode=mode), jds.MNIST(mode=mode))
        _items_equal(tds.FashionMNIST(mode=mode, transform=ttr.ToTensor()),
                     jds.FashionMNIST(mode=mode, transform=jtr.ToTensor()))


def test_cached_arrays(cache):
    with pytest.raises(IOError, match="flowers_train.npz"):
        tds.FlowersArrays()
    with pytest.raises(NotImplementedError):
        tds.Flowers()
    rng = np.random.default_rng(4)
    np.savez(cache / "flowers_test.npz",
             images=rng.integers(0, 256, (3, 8, 8, 3), dtype=np.uint8),
             labels=np.array([5, 0, 101]))
    np.savez(cache / "voc2012_train.npz",
             images=rng.integers(0, 256, (2, 6, 6, 3), dtype=np.uint8),
             masks=rng.integers(0, 21, (2, 6, 6), dtype=np.uint8))
    _items_equal(tds.FlowersArrays(mode="test"),
                 jds.FlowersArrays(mode="test"))
    _items_equal(tds.VOC2012(), jds.VOC2012())
