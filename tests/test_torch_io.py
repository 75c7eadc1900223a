"""The port's ``paddle.io`` against the reference's
(``paddle_tpu/io/__init__.py``) on the CPU: under one numpy seed the two
``DataLoader``s hand out the same batches in the same order, with
``num_workers`` 0 and 2 (the datasets draw augmentation noise from the
global ``np.random``, which each worker reseeds), over two epochs;
``DistributedBatchSampler``'s shards; ``state_dict`` resume; the collate
dtypes (ints int64, floats float32; the reference narrows int64 to int32,
ROADMAP C26); and the device rule (CUDA by default: without it the
loader raises unless ``set_device("cpu")`` was called)."""
import multiprocessing as mp
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as jio

import paddle_tpu_torch as pt
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import core as tcore

N, FEAT = 22, 5


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    dev, n = tcore.get_device(), torch.get_num_threads()
    pt.set_device("cpu")
    torch.set_num_threads(1)
    yield
    pt.set_device(dev)
    torch.set_num_threads(n)


def _table(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, FEAT), rng.randint(0, 10, N))


class Noisy:
    """A map dataset of (float64 features + noise drawn from the global
    ``np.random``, int label): its batches show which process drew what."""

    def __init__(self):
        self.x, self.y = _table()

    def __getitem__(self, i):
        return self.x[i] + np.random.randn(FEAT), int(self.y[i])

    def __len__(self):
        return N


def _np(x):
    if isinstance(x, paddle.Tensor):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _epochs(io_mod, epochs=2, seed=7, **kw):
    """``epochs`` epochs of a loader over :class:`Noisy`, the global numpy
    seed set once before: each batch as numpy arrays."""
    ds = Noisy()
    if io_mod is jio:
        kw.setdefault("use_shared_memory", False)
    loader = io_mod.DataLoader(ds, **kw)
    np.random.seed(seed)
    return [[[_np(t) for t in batch] for batch in loader]
            for _ in range(epochs)]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for e, (ge, we) in enumerate(zip(got, want)):
        assert len(ge) == len(we), f"epoch {e}"
        for b, (gb, wb) in enumerate(zip(ge, we)):
            for g, w in zip(gb, wb):
                assert g.shape == w.shape, f"epoch {e} batch {b}"
                np.testing.assert_array_equal(g, w.astype(g.dtype),
                                              err_msg=f"epoch {e} batch {b}")


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, True)])
def test_batches_equal_the_reference(num_workers, shuffle, drop_last):
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last,
              num_workers=num_workers)
    got, want = _epochs(tio, **kw), _epochs(jio, **kw)
    _assert_same_batches(got, want)
    x, y = got[0][0]
    assert x.dtype == np.float32 and y.dtype == np.int64


def test_batches_without_the_prefetch_thread():
    kw = dict(batch_size=5, shuffle=True, use_buffer_reader=False)
    _assert_same_batches(_epochs(tio, **kw), _epochs(jio, **kw))


@pytest.mark.parametrize("shuffle", [False, True])
def test_distributed_batch_sampler_shards(shuffle):
    ds = list(range(N))
    for rank in range(3):
        js = jio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                         shuffle=shuffle, drop_last=False)
        ts = tio.DistributedBatchSampler(ds, 4, num_replicas=3, rank=rank,
                                         shuffle=shuffle, drop_last=False)
        for epoch in (0, 1):
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert list(ts) == list(js)
            assert len(ts) == len(js)
    one = tio.DistributedBatchSampler(ds, 4)        # no group: one replica
    assert (one.nranks, one.local_rank) == (1, 0)
    assert sorted(i for b in one for i in b) == ds


def test_batch_sampler_state_dict_resume():
    ds = list(range(N))
    got = {}
    for name, io_mod in (("port", tio), ("ref", jio)):
        s = io_mod.BatchSampler(ds, shuffle=True, batch_size=3, seed=11)
        s.set_epoch(2)
        it = iter(s)
        head = [next(it), next(it)]
        state = s.state_dict()
        s2 = io_mod.BatchSampler(ds, shuffle=True, batch_size=3, seed=0)
        s2.set_state_dict(state)
        got[name] = (head, state, list(s2), list(s2))
    assert got["port"] == got["ref"]
    assert got["port"][1] == {"epoch": 2, "consumed_batches": 2, "seed": 11}


def test_loader_state_dict_resume_with_distributed_sampler():
    ds = Noisy()
    sampler = tio.DistributedBatchSampler(ds, 4, num_replicas=1, rank=0,
                                          shuffle=True)
    loader = tio.DataLoader(ds, batch_sampler=sampler)
    np.random.seed(3)
    it = iter(loader)
    next(it)
    next(it)
    state = loader.state_dict()
    it.close()
    assert state == {"epoch": 0, "consumed_batches": 2}
    resumed = tio.DataLoader(ds, batch_sampler=tio.DistributedBatchSampler(
        ds, 4, num_replicas=1, rank=0, shuffle=True))
    resumed.set_state_dict(state)
    labels = [b[1].tolist() for b in resumed]
    order = tio.DistributedBatchSampler(ds, 4, num_replicas=1, rank=0,
                                        shuffle=True)._batches()
    assert labels == [[int(ds.y[i]) for i in b] for b in order[2:]]


def test_collate_dtypes_match_the_reference():
    batch = [{"a": 1, "b": 0.5, "c": np.ones(2, np.float64),
              "d": (np.int32(3), "s")} for _ in range(3)]
    got, want = tio.default_collate_fn(batch), jio.default_collate_fn(batch)
    for k in "abc":
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    assert got["a"].dtype == np.int64 and got["b"].dtype == np.float32
    assert got["d"][1] == want["d"][1] == ["s"] * 3
    ts = tio.default_collate_fn([torch.ones(2), torch.zeros(2)])
    assert isinstance(ts, np.ndarray) and ts.shape == (2, 2)


def test_datasets_and_random_split_match_the_reference():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    for io_mod, wrap in ((tio, torch.from_numpy), (jio, paddle.to_tensor)):
        td = io_mod.TensorDataset([wrap(x), wrap(x * 2)])
        assert len(td) == 6 and float(_np(td[2][1])[0]) == 8.0
        cd = io_mod.ConcatDataset([list(range(3)), list(range(10, 14))])
        assert [cd[i] for i in range(len(cd))] == [0, 1, 2, 10, 11, 12, 13]
        assert cd[-1] == 13
        comp = io_mod.ComposeDataset([[(1, 2)] * 3, [3] * 4])
        assert len(comp) == 3 and comp[0] == (1, 2, 3)
        chain = io_mod.ChainDataset([[1, 2], [3]])
        assert [v for v in chain] == [1, 2, 3]   # list() asks len()
    np.random.seed(5)
    tsplit = tio.random_split(list(range(10)), [0.3, 0.7])
    np.random.seed(5)
    jsplit = jio.random_split(list(range(10)), [0.3, 0.7])
    assert [s.indices for s in tsplit] == [s.indices for s in jsplit]


class Stream(tio.IterableDataset):
    def __iter__(self):
        return iter(range(7))


def test_iterable_dataset_batches():
    loader = tio.DataLoader(Stream(), batch_size=3, drop_last=False)
    assert [b.tolist() for b in loader] == [[0, 1, 2], [3, 4, 5], [6]]
    with pytest.raises(TypeError):
        len(loader)


class Broken(tio.Dataset):
    def __getitem__(self, i):
        raise KeyError("bad sample")

    def __len__(self):
        return 4


def test_worker_error_reaches_the_consumer():
    loader = tio.DataLoader(Broken(), batch_size=2, num_workers=2)
    with pytest.raises(RuntimeError, match="bad sample"):
        list(loader)


class Counted(tio.Dataset):
    """Sample ``i`` is ``[i]``; every read adds one to a counter the
    forked workers share."""

    def __init__(self, n):
        self.n = n
        self.reads = mp.get_context("fork").Value("i", 0)

    def __getitem__(self, i):
        with self.reads.get_lock():
            self.reads.value += 1
        return np.array([i], np.int64)

    def __len__(self):
        return self.n


@pytest.mark.parametrize("buffered", [False, True])
def test_workers_stay_a_bounded_number_of_batches_ahead(buffered):
    """The workers collate at most ``max(2, prefetch_factor)`` batches a
    worker past those handed on (and the prefetch thread holds at most
    ``prefetch_factor`` more, plus the one it is putting), whatever the
    consumer's pace; the epoch still arrives whole and in order."""
    ds = Counted(60)
    loader = tio.DataLoader(ds, batch_size=1, num_workers=2,
                            prefetch_factor=3, use_buffer_reader=buffered)
    limit = max(2 * 2, 3 * 2)
    it = iter(loader)
    got = [int(next(it)[0]) for _ in range(4)]
    time.sleep(1.5)                     # an unbounded pool reads all 60
    ahead = ds.reads.value - len(got)
    assert ahead <= limit + (3 + 1 if buffered else 0), ahead
    got += [int(b[0]) for b in it]
    assert got == list(range(60))


def test_loader_places_on_the_current_device_and_counts_waits():
    ds = Noisy()
    loader = tio.DataLoader(ds, batch_size=4)
    np.random.seed(0)
    batches = list(loader)
    assert all(t.device.type == "cpu" for b in batches for t in b)
    assert loader.stats["batches"] == len(batches) == 6
    assert loader.stats["wait_s"] >= loader.stats["max_wait_s"] > 0
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        iter(tio.DataLoader(ds, places="gpu:0"))
    pt.set_device("gpu")
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            iter(loader)
    finally:
        pt.set_device("cpu")
