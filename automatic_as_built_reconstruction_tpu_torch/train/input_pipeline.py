"""Host input pipeline: dataset -> prep -> batched prefetch.

The port's copy of the JAX package's ``train/input_pipeline.py``.  Three
producers, all batch-order deterministic (tasks are submitted in stream
order and collected in submission order; each example's rng is seeded by
``epoch * 1_000_003 + index + seed``):

- one background thread (``num_workers`` 1): examples one after another;
- a thread pool (``num_workers`` > 1): the numpy prep, which releases the
  GIL in its large array operations, runs ahead of the device step on a
  few threads;
- a fork-inherited process pool (``process_workers``): the workers
  inherit the prep closure by fork through ``_FORK_REGISTRY`` (the
  closures hold lambdas and are not picklable; only (key, idx, seed)
  tasks and example dicts cross the pipe).

Without a ground-truth sampler every producer gives the same batches.  A
sampler keeps one generator for all examples, as in the reference: in a
thread pool the workers draw from it in the order they reach it, and
each forked worker draws from its own copy of its state at the fork.
The batches then depend on the pool, as the reference's do.  Bucketed
padding is not ported.
"""
from __future__ import annotations

import functools
import multiprocessing as mp
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterator

import numpy as np

from ..data import batching

# fork-inherited state for process workers: the child resolves the prep
# dataset through this registry (its entry is added before the pool
# forks and fork inherits the whole dict), so nothing unpicklable ever
# crosses the process boundary.  Keyed, so several process-backed
# loaders can coexist.
_FORK_REGISTRY: dict = {}


def _fork_worker_example(key: int, idx: int, seed: int) -> dict:
    return _FORK_REGISTRY[key].example(idx, seed)


class PrepDataset:
    """Dataset + prep closure; index-addressable examples."""

    def __init__(self, dataset, prep_fn: Callable[[dict, np.random.Generator],
                                                  dict]):
        self._dataset = dataset
        self._prep_fn = prep_fn

    def __len__(self):
        return len(self._dataset)

    def example(self, idx: int, seed: int) -> dict:
        rng = np.random.default_rng(seed)
        return self._prep_fn(self._dataset.get_sensor_data(idx), rng)

    @property
    def dataset(self):
        return self._dataset


class BatchLoader:
    """Infinite (``repeat``) or one-epoch batched iterator with background
    prefetch of up to ``prefetch`` batches."""

    def __init__(self, prep_dataset: PrepDataset, batch_size: int,
                 shuffle: bool, num_workers: int = 1, seed: int = 0,
                 prefetch: int = 4, drop_last: bool = True,
                 repeat: bool = True, buckets=None, bucket_plans=None,
                 process_workers: bool = False):
        if buckets or bucket_plans:
            raise NotImplementedError("bucketed padding is not ported")
        self._ds = prep_dataset
        self._batch_size = batch_size
        self._shuffle = shuffle
        self._workers = max(int(num_workers), 1)
        self._process_workers = bool(process_workers)
        self._seed = seed
        self._prefetch = prefetch
        self._drop_last = drop_last
        self._repeat = repeat

    def _index_stream(self) -> Iterator[tuple]:
        rng = np.random.default_rng(self._seed)
        epoch = 0
        n = len(self._ds)
        while True:
            order = rng.permutation(n) if self._shuffle else np.arange(n)
            for i in order:
                yield int(i), int(epoch * 1_000_003 + i + self._seed)
            epoch += 1
            if not self._repeat:
                return

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        stop = threading.Event()
        if self._process_workers:
            target = self._process_producer
        elif self._workers > 1:
            target = self._pooled_producer
        else:
            target = self._sequential_producer
        threading.Thread(target=target, args=(q, stop), daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # unblock a producer waiting on a full queue, so that it sees
            # the stop and shuts its pool down
            while not q.empty():
                q.get_nowait()

    def _put(self, q, stop, item) -> bool:
        """Put ``item`` unless the consumer has gone; -> whether it did."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _sequential_producer(self, q, stop):
        try:
            batch = []
            for idx, seed in self._index_stream():
                if stop.is_set():
                    return
                batch.append(self._ds.example(idx, seed))
                if len(batch) == self._batch_size:
                    if not self._put(q, stop, batching.merge_batch(batch)):
                        return
                    batch = []
            if batch and not self._drop_last:
                self._put(q, stop, batching.merge_batch(batch))
        except Exception as e:  # surface worker errors to the consumer
            self._put(q, stop, e)
        finally:
            self._put(q, stop, None)

    def _pooled_producer(self, q, stop):
        self._pool_producer(q, stop, ThreadPoolExecutor(self._workers),
                            self._ds.example)

    def _process_producer(self, q, stop):
        """Fork-inherited process pool (the lineage DataLoader model);
        the thread pool where fork is unavailable (the prep closures are
        not picklable)."""
        try:
            ctx = mp.get_context("fork")
        except ValueError:
            return self._pooled_producer(q, stop)
        key = id(self._ds)
        _FORK_REGISTRY[key] = self._ds   # inherited at fork time
        try:
            pool = ProcessPoolExecutor(self._workers, mp_context=ctx)
            self._pool_producer(q, stop, pool,
                                functools.partial(_fork_worker_example, key))
        finally:
            _FORK_REGISTRY.pop(key, None)

    def _pool_producer(self, q, stop, pool, submit_fn):
        try:
            with pool:
                pending = []
                stream = self._index_stream()
                exhausted = False
                while not stop.is_set():
                    while (len(pending) < self._batch_size * 2
                           and not exhausted):
                        try:
                            idx, seed = next(stream)
                        except StopIteration:
                            exhausted = True
                            break
                        pending.append(pool.submit(submit_fn, idx, seed))
                    if len(pending) >= self._batch_size:
                        batch = [f.result() for f in
                                 pending[:self._batch_size]]
                        pending = pending[self._batch_size:]
                        if not self._put(q, stop,
                                         batching.merge_batch(batch)):
                            break
                    elif exhausted:
                        if pending and not self._drop_last:
                            self._put(q, stop, batching.merge_batch(
                                [f.result() for f in pending]))
                        break
                for f in pending:
                    f.cancel()
        except Exception as e:
            self._put(q, stop, e)
        finally:
            self._put(q, stop, None)
