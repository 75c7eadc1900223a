"""``paddle.vision.datasets`` (port of
``paddle_tpu/vision/datasets/__init__.py``): ``FakeData``,
``Cifar10`` / ``Cifar100`` (the pickled-batch tarballs or the extracted
``cifar-10-batches-py``), ``MNIST`` / ``FashionMNIST`` (the idx ``.gz``
files), ``FlowersArrays`` and ``VOC2012`` (pre-extracted ``.npz``).

They read the reference's cache layout under ``~/.cache/paddle/dataset``
(resolved at construction, so a changed ``HOME`` is seen) and download
nothing: a missing file raises naming where it belongs. They are host
code on ``io.Dataset``: items are numpy arrays (or what ``transform``
makes of them), and nothing touches CUDA, so they run in ``DataLoader``
workers. ``FakeData`` draws from ``RandomState(seed)`` exactly as the
reference does.
"""
from __future__ import annotations

import gzip
import os
import pickle
import tarfile

import numpy as np

from ..._cache import DATASET_HOME, dataset_cache_path
from ...io import Dataset


def _root():
    return os.path.expanduser(DATASET_HOME)


class FakeData(Dataset):
    """Deterministic synthetic image classification dataset."""

    def __init__(self, size=256, image_shape=(3, 32, 32), num_classes=10,
                 transform=None, seed=0):
        self.size = size
        self.image_shape = tuple(image_shape)
        self.num_classes = num_classes
        self.transform = transform
        rng = np.random.RandomState(seed)
        self.images = rng.randint(0, 256, (size,) + self.image_shape[1:] +
                                  (self.image_shape[0],), dtype=np.uint8)
        self.labels = rng.randint(0, num_classes, (size,), dtype=np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = np.transpose(img.astype(np.float32) / 255.0, (2, 0, 1))
        return img, int(self.labels[idx])

    def __len__(self):
        return self.size


class Cifar10(Dataset):
    """CIFAR-10 from the standard ``cifar-10-python.tar.gz`` / extracted
    ``cifar-10-batches-py`` layout under ``data_file`` or the default cache."""

    MEAN = [0.4914, 0.4822, 0.4465]
    STD = [0.2470, 0.2435, 0.2616]

    def __init__(self, data_file=None, mode="train", transform=None,
                 download=True, backend="cv2"):
        self.mode = mode
        self.transform = transform
        data, labels = self._load(data_file)
        self.data = data
        self.labels = labels

    def _candidate_paths(self, data_file):
        cands = []
        if data_file:
            cands.append(data_file)
        cands += [
            os.path.join(_root(), "cifar", "cifar-10-python.tar.gz"),
            os.path.join(_root(), "cifar-10-python.tar.gz"),
            os.path.join(_root(), "cifar", "cifar-10-batches-py"),
        ]
        return cands

    def _load(self, data_file):
        batches = [f"data_batch_{i}" for i in range(1, 6)] \
            if self.mode == "train" else ["test_batch"]
        for path in self._candidate_paths(data_file):
            if not path or not os.path.exists(path):
                continue
            if path.endswith(".tar.gz"):
                data, labels = [], []
                with tarfile.open(path) as tf:
                    for b in batches:
                        f = tf.extractfile(f"cifar-10-batches-py/{b}")
                        d = pickle.load(f, encoding="bytes")
                        data.append(d[b"data"])
                        labels.extend(d[b"labels"])
                return (np.concatenate(data).reshape(-1, 3, 32, 32),
                        np.asarray(labels, np.int64))
            if os.path.isdir(path):
                data, labels = [], []
                for b in batches:
                    with open(os.path.join(path, b), "rb") as f:
                        d = pickle.load(f, encoding="bytes")
                    data.append(d[b"data"])
                    labels.extend(d[b"labels"])
                return (np.concatenate(data).reshape(-1, 3, 32, 32),
                        np.asarray(labels, np.int64))
        raise FileNotFoundError(
            "CIFAR-10 archive not found locally and nothing is downloaded; "
            "place cifar-10-python.tar.gz under "
            f"{_root()}/cifar/ or use vision.datasets.FakeData")

    def __getitem__(self, idx):
        img = np.transpose(self.data[idx], (1, 2, 0))  # HWC uint8
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = np.transpose(img.astype(np.float32) / 255.0, (2, 0, 1))
        return img, int(self.labels[idx])

    def __len__(self):
        return len(self.data)


class Cifar100(Cifar10):
    def _load(self, data_file):
        fname = "train" if self.mode == "train" else "test"
        for path in [data_file,
                     os.path.join(_root(), "cifar", "cifar-100-python.tar.gz")]:
            if not path or not os.path.exists(path):
                continue
            with tarfile.open(path) as tf:
                f = tf.extractfile(f"cifar-100-python/{fname}")
                d = pickle.load(f, encoding="bytes")
            return (d[b"data"].reshape(-1, 3, 32, 32),
                    np.asarray(d[b"fine_labels"], np.int64))
        raise FileNotFoundError("CIFAR-100 archive not found locally")


class MNIST(Dataset):
    def __init__(self, image_path=None, label_path=None, mode="train",
                 transform=None, download=True, backend=None):
        self.transform = transform
        prefix = "train" if mode == "train" else "t10k"
        root = os.path.join(_root(), "mnist")
        image_path = image_path or os.path.join(root, f"{prefix}-images-idx3-ubyte.gz")
        label_path = label_path or os.path.join(root, f"{prefix}-labels-idx1-ubyte.gz")
        if not (os.path.exists(image_path) and os.path.exists(label_path)):
            raise FileNotFoundError(
                f"MNIST files not found at {root}; nothing is downloaded — "
                "use vision.datasets.FakeData for synthetic data")
        with gzip.open(image_path, "rb") as f:
            buf = f.read()
            self.images = np.frombuffer(buf, np.uint8, offset=16).reshape(-1, 28, 28)
        with gzip.open(label_path, "rb") as f:
            buf = f.read()
            self.labels = np.frombuffer(buf, np.uint8, offset=8).astype(np.int64)

    def __getitem__(self, idx):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = (img.astype(np.float32) / 255.0)[None]
        return img, int(self.labels[idx])

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    pass


class _CachedVisionDataset(Dataset):
    """A dataset read from its file in the dataset cache (or
    ``data_file``); a miss raises ``IOError`` naming the path."""

    _filename = None

    def __init__(self, data_file=None, mode="train", transform=None, **kw):
        self.mode = mode
        self.transform = transform
        if data_file is None:
            data_file = dataset_cache_path(self._filename)
        if not os.path.exists(data_file):
            raise IOError(
                f"{type(self).__name__}: nothing is downloaded: place the "
                f"archive at {data_file}")
        self.data_file = data_file
        self._load()

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        img, label = self.samples[i]
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class Flowers:
    """102-category flowers. The raw ``102flowers.tgz`` needs JPEG
    decoding, which the package does not carry: use
    :class:`FlowersArrays` with a pre-extracted ``flowers_<mode>.npz``;
    this class says so at construction."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "Flowers: jpeg decoding is unavailable offline; extract the "
            "archive to flowers_<mode>.npz ({'images': uint8 NHWC, "
            "'labels': int64}) and use vision.datasets.FlowersArrays")


class FlowersArrays(_CachedVisionDataset):
    """Flowers from a pre-extracted ``flowers_<mode>.npz`` (images uint8
    NHWC + labels int64) — the decoded-array path for offline machines."""

    def __init__(self, data_file=None, mode="train", transform=None, **kw):
        self._filename = f"flowers_{mode}.npz"
        super().__init__(data_file, mode, transform, **kw)

    def _load(self):
        blob = np.load(self.data_file)
        self.samples = [(blob["images"][i], int(blob["labels"][i]))
                        for i in range(len(blob["labels"]))]


class VOC2012(_CachedVisionDataset):
    """Pascal VOC 2012 segmentation pairs from a pre-extracted
    ``voc2012_<mode>.npz`` ({'images': uint8 NHWC, 'masks': uint8 NHW})."""

    def __init__(self, data_file=None, mode="train", transform=None, **kw):
        self._filename = f"voc2012_{mode}.npz"
        super().__init__(data_file, mode, transform, **kw)

    def _load(self):
        blob = np.load(self.data_file)
        self.samples = [(blob["images"][i], blob["masks"][i])
                        for i in range(len(blob["images"]))]
