"""One-thread batch prefetcher (counterpart of
``categoricalnf_tpu/data/prefetch.py``).

A daemon thread builds the next numpy batches and, through ``transform``
(``pin``), puts them in pinned host memory; ``to_device`` then copies a
batch to the card with ``non_blocking``, so that batch generation and the
host-to-device copy overlap the training step.  A
bounded queue keeps it ``DEPTH`` batches ahead; an error in the thread is
raised in the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from categoricalnf_tpu_torch.utils.tree import tree_map

DEPTH = 4


def pin(batch: dict) -> dict:
    """numpy arrays (nested dicts of them, such as a dict ``cond``) ->
    tensors in pinned host memory (run in the thread)."""
    return tree_map(lambda v: torch.as_tensor(np.asarray(v)).pin_memory(),
                    batch)


def to_device(batch: dict, device) -> dict:
    """Tensors or arrays, nested as ``pin`` takes them -> ``device``.  From
    pinned memory the copy is queued without blocking on the current
    stream, so it overlaps the work already queued; the caching host
    allocator keeps the pinned buffer until the copy is done."""
    return tree_map(lambda v: torch.as_tensor(v).to(device,
                                                    non_blocking=True),
                    batch)


class Prefetcher:
    def __init__(self, it: Iterator, transform=None):
        self._it = it
        self._transform = transform
        self._q: queue.Queue = queue.Queue(maxsize=DEPTH)
        self._err = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                if self._transform is not None:
                    item = self._transform(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # surfaced to the consumer
            self._err = e
        finally:
            try:
                self._q.put_nowait(_STOP)
            except queue.Full:
                pass

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is _STOP:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self):
        """Stop the thread (it finishes the batch it is building)."""
        self._stop.set()
        self._thread.join(timeout=30)


_STOP = object()
