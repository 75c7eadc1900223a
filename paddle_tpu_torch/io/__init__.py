"""paddle.io: datasets, samplers and ``DataLoader`` (port of
``paddle_tpu/io/__init__.py``).

Datasets and samplers are the reference's, drawing from the same numpy
random streams: ``RandomSampler`` and ``random_split`` from the global
``np.random``, a seeded ``BatchSampler`` and ``DistributedBatchSampler``
from ``np.random.RandomState`` of the seed and epoch, and each worker
reseeds ``np.random`` with ``base_seed + worker_id``, ``base_seed`` drawn
from the global stream after the epoch's batches. Under one numpy seed
the port hands out the reference's batches in the reference's order.

``DataLoader`` places its batches on ``paddle.get_device()`` (``places``
overrides it): CUDA by default, so without CUDA it raises unless
``set_device("cpu")`` was called. numpy arrays become tensors in their
dtype, float64 in the default float dtype (as the reference's ``Tensor``
takes them); ``default_collate_fn`` makes ints int64 and floats float32.

The pipeline: worker processes (``num_workers > 0``) collate numpy
batches and send them through ``multiprocessing`` queues, never touching
CUDA (a process forked after CUDA's initialisation must not use it); the
batches are put back in order. The workers run at most
``max(2, prefetch_factor)`` batches a worker ahead of the consumer, the
slots of the reference's shared-memory queue, so host memory holds a few
batches, not the epoch. With ``use_buffer_reader`` (the default)
a thread keeps ``prefetch_factor`` batches ahead (the reference's
buffered reader, depth 2): it pins each array and copies it to the card
on a side stream, and the consumer's stream waits on that copy's event
before it reads the batch. ``use_shared_memory`` is accepted and changes
nothing: the batches travel pickled through the queues (the reference's
native shared-memory queue, ``io/native``, is not ported).

Each iteration records what the training loop waited for its batches in
``DataLoader.stats``: ``batches``, ``wait_s`` (the summed host time
blocked in ``next``), ``max_wait_s`` and ``depth`` (the prefetch queue's
depth at the last hand-off).
"""
from __future__ import annotations

import atexit
import math
import multiprocessing as mp
import queue
import threading
import time
import weakref

import numpy as np
import torch

from ..framework import dtype as dtypes

# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise RuntimeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (list, tuple)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(d) for d in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        di = int(np.searchsorted(self.cum, idx, side="right"))
        prev = 0 if di == 0 else self.cum[di - 1]
        return self.datasets[di][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Subsets of a permutation drawn from the global ``np.random``;
    fractional ``lengths`` give the remainder to the last."""
    if all(isinstance(n, float) for n in lengths):
        total = len(dataset)
        lengths = [int(math.floor(total * f)) for f in lengths]
        lengths[-1] += len(dataset) - sum(lengths)
    perm = np.random.permutation(len(dataset)).tolist()
    out, offset = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[offset:offset + n]))
        offset += n
    return out


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray([float(w) for w in weights])
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(self.weights), self.num_samples,
                                     replace=self.replacement, p=p).tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    """A random permutation of an explicit index subset."""

    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        return iter(np.random.permutation(self.indices).tolist())

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    """The default batch sampler. With a ``seed`` the shuffle order is a
    function of ``(seed, epoch)`` alone, and ``state_dict()`` /
    ``set_state_dict()`` (epoch, consumed batches, seed) let a restored
    loader skip the batches already handed out. Without a seed a shuffle
    draws from the global ``np.random`` (resumable only unshuffled)."""

    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False, seed=None):
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.shuffle = shuffle
        self.seed = seed
        self.epoch = 0
        self._own_sampler = sampler is None
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    _consumed = 0       # batches yielded so far this epoch
    _resume_from = 0    # one-shot skip armed by set_state_dict

    def _index_iter(self):
        if self.shuffle and self.seed is not None and self._own_sampler:
            n = len(self.sampler.data_source)
            rng = np.random.RandomState((int(self.seed) + self.epoch)
                                        % (2 ** 31))
            return iter(rng.permutation(n).tolist())
        return iter(self.sampler)

    def __iter__(self):
        skip, self._resume_from = self._resume_from, 0
        if skip and self.shuffle and self._own_sampler and self.seed is None:
            raise ValueError(
                "BatchSampler resume with shuffle=True needs a seed "
                "(the shuffle order is otherwise unreproducible)")
        produced = 0
        batch = []
        for idx in self._index_iter():
            batch.append(idx)
            if len(batch) == self.batch_size:
                produced += 1
                if produced > skip:
                    self._consumed = produced
                    yield batch
                batch = []
        if batch and not self.drop_last:
            produced += 1
            if produced > skip:
                self._consumed = produced
                yield batch
        if skip > produced:
            raise ValueError(
                f"sampler resume state skips {skip} batches but this epoch "
                f"has only {produced}: the checkpoint was taken with a "
                "different batch size or dataset")
        self._consumed = 0             # exhausted: the next epoch is fresh

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = int(epoch)

    def state_dict(self):
        return {"epoch": self.epoch, "consumed_batches": self._consumed,
                "seed": self.seed}

    def set_state_dict(self, state):
        self.epoch = int(state.get("epoch", 0))
        if state.get("seed") is not None:
            self.seed = state["seed"]
        self._resume_from = int(state.get("consumed_batches", 0))
        self._consumed = self._resume_from

    load_state_dict = set_state_dict


def _world():
    """(world size, rank) of the initialised ``torch.distributed`` group,
    else (1, 0)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """Batches sharded over ``num_replicas`` ranks: the indices (shuffled
    by ``RandomState(epoch)``) padded to a multiple of the ranks and dealt
    round-robin. ``num_replicas`` and ``rank`` default to the initialised
    ``torch.distributed`` group's, else one replica."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        world, me = _world()
        self.nranks = world if num_replicas is None else num_replicas
        self.local_rank = me if rank is None else rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def _batches(self):
        indices = np.arange(len(self.dataset)).tolist()
        if self.shuffle:
            rng = np.random.RandomState(self.epoch)
            rng.shuffle(indices)
        indices += indices[: (self.total_size - len(indices))]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        out = [indices[i:i + self.batch_size]
               for i in range(0, len(indices), self.batch_size)]
        if self.drop_last and out and len(out[-1]) < self.batch_size:
            out.pop()
        return out

    def __iter__(self):
        # a one-shot resume offset: only the iteration right after
        # set_state_dict skips
        skip, self._resume_from = self._resume_from, 0
        batches = self._batches()
        if skip > len(batches):
            raise ValueError(
                f"sampler resume state skips {skip} batches but this "
                f"epoch has only {len(batches)}: the checkpoint was "
                "taken with a different batch size, dataset or replicas")
        for b_idx in range(skip, len(batches)):
            self._consumed = b_idx + 1
            yield batches[b_idx]
        self._consumed = 0

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch

    def state_dict(self):
        """The epoch and the batches consumed: restoring, then iterating,
        skips exactly those (the epoch seeds the permutation)."""
        return {"epoch": self.epoch, "consumed_batches": self._consumed}

    def set_state_dict(self, state):
        self.epoch = int(state.get("epoch", 0))
        self._resume_from = int(state.get("consumed_batches", 0))
        self._consumed = self._resume_from

    load_state_dict = set_state_dict


# ---------------------------------------------------------------------------
# collate and placement
# ---------------------------------------------------------------------------

def default_collate_fn(batch):
    """Samples -> numpy batch: arrays and tensors stacked, ints int64,
    floats float32, lists, tuples and dicts field by field, strings kept
    as a list."""
    sample = batch[0]
    if isinstance(sample, (np.ndarray, np.generic)):
        return np.stack([np.asarray(b) for b in batch])
    if isinstance(sample, torch.Tensor):
        return np.stack([b.numpy(force=True) for b in batch])
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, float):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(t)) for t in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, (str, bytes)):
        return list(batch)
    return np.asarray(batch)


def default_convert_fn(batch):
    return batch


def _map(batch, kind, fn):
    """``batch`` with every leaf of type ``kind`` replaced by ``fn(leaf)``
    (lists and tuples become lists)."""
    if isinstance(batch, kind):
        return fn(batch)
    if isinstance(batch, (list, tuple)):
        return [_map(b, kind, fn) for b in batch]
    if isinstance(batch, dict):
        return {k: _map(v, kind, fn) for k, v in batch.items()}
    return batch


def _host_tensor(arr):
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if t.dtype == torch.float64:
        t = t.to(dtypes.default_float())
    return t


class _Placer:
    """Moves numpy batches to ``device``. On CUDA each array is pinned
    and copied on a side stream; the batch carries the copy's event, and
    :meth:`ready` makes the consumer's stream wait on it."""

    def __init__(self, device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def __call__(self, np_batch):
        if not self.cuda:
            return _map(np_batch, np.ndarray, _host_tensor), None
        with torch.cuda.stream(self.stream):
            out = _map(np_batch, np.ndarray, lambda a: _host_tensor(a)
                       .pin_memory().to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def ready(self, batch, event):
        """The batch, once the consumer's stream has waited on its copy
        (and its memory is marked as used there)."""
        if event is None:
            return batch
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)

        def used_here(t):
            t.record_stream(stream)
            return t

        return _map(batch, torch.Tensor, used_here)


# ---------------------------------------------------------------------------
# workers
# ---------------------------------------------------------------------------

def _worker_loop(dataset, index_queue, result_queue, collate_fn, worker_id,
                 worker_init_fn, base_seed):
    """A worker: numpy batches for the index lists it is sent, in the
    order sent; errors go back with their traceback. It never touches
    CUDA."""
    torch.set_num_threads(1)
    np.random.seed((base_seed + worker_id) % (2 ** 31))
    if worker_init_fn is not None:
        worker_init_fn(worker_id)
    while True:
        item = index_queue.get()
        if item is None:
            break
        bidx, indices = item
        try:
            batch = collate_fn([dataset[i] for i in indices])
            result_queue.put((bidx, batch, None))
        except Exception as e:          # noqa: BLE001 — sent to the consumer
            import traceback
            result_queue.put((bidx, None, f"{e}\n{traceback.format_exc()}"))


class _MultiprocessIter:
    """Index queues out, one result queue back, reassembled in order; each
    batch placed by ``placer`` as it leaves. At most ``limit`` batches
    (``max(2, prefetch_factor)`` a worker, the slots of the reference's
    shared-memory queue) are sent out and not yet handed on: the next
    batch's indices go out as one leaves."""

    def __init__(self, loader, placer):
        self.placer = placer
        _LIVE_ITERS.add(self)
        self._lock = threading.Lock()
        self._shut = False
        self.batches = list(iter(loader.batch_sampler))
        self.n = len(self.batches)
        ctx = mp.get_context("fork" if "fork" in mp.get_all_start_methods()
                             else "spawn")
        nw = loader.num_workers
        self.result_queue = ctx.Queue()
        self.index_queues = [ctx.Queue() for _ in range(nw)]
        base_seed = int(np.random.randint(0, 2 ** 31))
        self.workers = []
        for w in range(nw):
            p = ctx.Process(
                target=_worker_loop,
                args=(loader.dataset, self.index_queues[w], self.result_queue,
                      loader.collate_fn, w, loader.worker_init_fn, base_seed),
                daemon=True)
            p.start()
            self.workers.append(p)
        self.limit = max(2 * nw, loader.prefetch_factor * nw)
        self._pending = {}
        self._next = 0
        self._sent = 0
        self._send()

    def _send(self):
        """Indices out up to ``limit`` batches ahead of the consumer; the
        workers' end marks once every batch is out."""
        nw = len(self.workers)
        while self._sent < min(self.n, self._next + self.limit):
            self.index_queues[self._sent % nw].put(
                (self._sent, self.batches[self._sent]))
            self._sent += 1
            if self._sent == self.n:
                for q in self.index_queues:
                    q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        if self._next >= self.n:
            self.shutdown()
            raise StopIteration
        while self._next not in self._pending:
            try:
                bidx, batch, err = self.result_queue.get(timeout=5)
            except queue.Empty:
                if not any(p.is_alive() for p in self.workers):
                    self.shutdown()
                    raise RuntimeError(
                        "DataLoader workers exited unexpectedly") from None
                continue
            if err is not None:
                self.shutdown()
                raise RuntimeError(f"DataLoader worker failed: {err}")
            self._pending[bidx] = batch
        batch = self._pending.pop(self._next)
        self._next += 1
        self._send()
        return self.placer(batch)

    def shutdown(self):
        with self._lock:
            if self._shut:
                return
            self._shut = True
        for p in self.workers:
            if p.is_alive():
                p.terminate()
        for p in self.workers:
            p.join(timeout=5)
        for q in self.index_queues + [self.result_queue]:
            q.cancel_join_thread()
            q.close()

    def __del__(self):
        self.shutdown()


class _SingleProcessIter:
    def __init__(self, loader, placer):
        self.loader = loader
        self.placer = placer
        self.sampler_iter = iter(loader.batch_sampler)

    def __iter__(self):
        return self

    def __next__(self):
        indices = next(self.sampler_iter)
        samples = [self.loader.dataset[i] for i in indices]
        return self.placer(self.loader.collate_fn(samples))


def _prefetch_run(wref, inner, q, stop, done):
    """The producer of :class:`_PrefetchIter`. It holds its owner weakly,
    so an abandoned iterator lets it notice and exit instead of waiting
    on a full queue forever."""
    err = None
    try:
        for item in inner:
            while not stop.is_set():
                if wref() is None:
                    stop.set()
                    break
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if stop.is_set():
                return
    except Exception as e:              # noqa: BLE001 — raised by the consumer
        err = e
    finally:
        owner = wref()
        if owner is not None:
            owner.err = err
            owner.finished = True
        try:
            q.put_nowait(done)
        except queue.Full:
            pass
        if stop.is_set() or owner is None:
            close = getattr(inner, "shutdown", None)
            if close:
                close()


def _retire_live_iters():
    """At exit: shut every live iterator down while the interpreter is
    whole, prefetch wrappers first (they join their thread before the
    worker pool goes)."""
    for it in sorted(list(_LIVE_ITERS),
                     key=lambda x: not isinstance(x, _PrefetchIter)):
        try:
            it.shutdown()
        except Exception:               # noqa: BLE001 — exiting anyway
            pass


_LIVE_ITERS = weakref.WeakSet()
atexit.register(_retire_live_iters)


class _PrefetchIter:
    """Keeps ``depth`` placed batches ahead on a thread (the buffered
    reader)."""

    def __init__(self, inner, depth=2):
        self.inner = inner
        _LIVE_ITERS.add(self)
        self.depth = depth
        self.q = queue.Queue(maxsize=depth)
        self.done = object()
        self.err = None
        self.finished = False
        self._stop = threading.Event()
        self.thread = threading.Thread(
            target=_prefetch_run,
            args=(weakref.ref(self), inner, self.q, self._stop, self.done),
            daemon=True)
        self.thread.start()

    def shutdown(self):
        """Stop the producer (a mid-epoch break) and retire the worker
        pool behind it."""
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        close = getattr(self.inner, "shutdown", None)
        if close:
            close()
        self.thread.join(timeout=6)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self.q.get(timeout=0.1)
                break
            except queue.Empty:
                if self.finished or not self.thread.is_alive():
                    # the producer may have put its last batches after
                    # this get timed out: drain once more
                    try:
                        item = self.q.get_nowait()
                    except queue.Empty:
                        item = self.done
                    break
        if item is self.done:
            if self.err:
                raise self.err
            raise StopIteration
        return item


class DataLoader:
    """Batches of ``dataset`` on the current device (``places``
    overrides it); see the module's docstring. ``seed`` makes the
    default ``BatchSampler``'s shuffle resumable."""

    def __init__(self, dataset, feed_list=None, places=None, return_list=True,
                 batch_sampler=None, batch_size=1, shuffle=False,
                 drop_last=False, collate_fn=None, num_workers=0,
                 use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=True, timeout=0, worker_init_fn=None,
                 persistent_workers=False, seed=None):
        self.dataset = dataset
        self.places = places
        self.num_workers = int(num_workers)
        self.collate_fn = collate_fn or default_collate_fn
        self.worker_init_fn = worker_init_fn
        self.use_buffer_reader = use_buffer_reader
        self.use_shared_memory = use_shared_memory
        self.prefetch_factor = prefetch_factor
        self.return_list = return_list
        self.stats = {"batches": 0, "wait_s": 0.0, "max_wait_s": 0.0,
                      "depth": 0}
        self._iterable_mode = isinstance(dataset, IterableDataset)
        if self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last, seed=seed)

    _yielded = 0        # batches handed to the training loop this epoch

    def state_dict(self):
        """The sampler's resume state, with the batches handed to the
        training loop (not those prefetched) as consumed."""
        sd = getattr(self.batch_sampler, "state_dict", None)
        state = dict(sd()) if sd is not None else {
            "epoch": getattr(self.batch_sampler, "epoch", 0)}
        state["consumed_batches"] = self._yielded
        return state

    def set_state_dict(self, state):
        ss = getattr(self.batch_sampler, "set_state_dict", None)
        if ss is None:
            if state and state.get("consumed_batches"):
                raise ValueError(
                    "DataLoader resume needs a sampler with set_state_dict "
                    "(BatchSampler / DistributedBatchSampler); this custom "
                    "sampler cannot skip consumed batches")
            return
        ss(state)
        self._yielded = int(state.get("consumed_batches", 0))

    load_state_dict = set_state_dict

    def _device(self):
        from ..framework.core import device_of
        places = self.places
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        return device_of(places)

    def __iter__(self):
        device = self._device()
        base = getattr(self.batch_sampler, "_resume_from", 0)
        placer = _Placer(device)
        if self._iterable_mode:
            inner = self._iter_iterable(placer)
        elif self.num_workers > 0:
            inner = _MultiprocessIter(self, placer)
        else:
            inner = _SingleProcessIter(self, placer)
        inner = _PrefetchIter(inner, self.prefetch_factor) \
            if self.use_buffer_reader and not self._iterable_mode \
            else iter(inner)
        self._yielded = base
        self.stats = {"batches": 0, "wait_s": 0.0, "max_wait_s": 0.0,
                      "depth": 0}
        return self._counted(inner, placer)

    def _counted(self, inner, placer):
        stats, q = self.stats, getattr(inner, "q", None)
        try:
            while True:
                t0 = time.perf_counter()
                try:
                    batch, event = next(inner)
                except StopIteration:
                    self._yielded = 0          # a clean end of the epoch
                    break
                batch = placer.ready(batch, event)
                wait = time.perf_counter() - t0
                stats["batches"] += 1
                stats["wait_s"] += wait
                stats["max_wait_s"] = max(stats["max_wait_s"], wait)
                if q is not None:
                    stats["depth"] = q.qsize()
                # counted before it is handed out: a checkpoint inside the
                # loop body sees the current batch as consumed
                self._yielded += 1
                yield batch
        finally:
            stop = getattr(inner, "shutdown", None)
            if stop:
                stop()

    def _iter_iterable(self, place):
        batch = []
        for sample in self.dataset:
            batch.append(sample)
            if len(batch) == self.batch_size:
                yield place(self.collate_fn(batch))
                batch = []
        if batch and not self.drop_last:
            yield place(self.collate_fn(batch))

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    @staticmethod
    def from_generator(*args, **kwargs):
        raise NotImplementedError("from_generator is legacy; use Dataset")


def get_worker_info():
    return None


__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "SubsetRandomSampler", "BatchSampler",
           "DistributedBatchSampler", "default_collate_fn",
           "default_convert_fn", "DataLoader", "get_worker_info"]
