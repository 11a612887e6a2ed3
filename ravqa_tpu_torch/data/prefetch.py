"""Background-thread input prefetching (host/device overlap).

Port of ravqa_tpu/data/prefetch.py, the replacement for the reference's
DataLoader worker processes (common_data_opts.py:152-199, num_workers +
pin_memory): host batch assembly (tokenization, negative sampling,
collate) runs on a daemon thread a bounded number of batches ahead of the
consumer, and prefetch_to_device pushes each finished batch to the device
from that thread (pinned host memory, non_blocking copies), so the copy
overlaps the training step in flight. One thread suffices: the heavy host
work (the C++ WordPiece encoder through ctypes, numpy collate) releases
the GIL, and the step runs on the device while Python assembles the next
batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()


def prefetch(batches: Iterable, size: int = 2,
             transform: Optional[Callable] = None) -> Iterator:
    """Iterate `batches` on a daemon thread, keeping up to `size` finished
    batches buffered ahead of the consumer. Order-preserving. Exceptions
    raised by the source iterator are re-raised at the consuming site.

    transform: optional callable applied to each batch ON THE PRODUCER
    THREAD (e.g. a copy to the device) so its cost overlaps the
    consumer's compute.
    """
    assert size >= 1
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()

    def stop_aware_put(item) -> bool:
        """put() that gives up when the consumer has gone away — a plain
        blocking put here would park the daemon thread (and the batches it
        holds, device-resident under prefetch_to_device) forever."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if transform is not None:
                    b = transform(b)
                if not stop_aware_put(b):
                    return
            stop_aware_put(_SENTINEL)
        except BaseException as e:                     # re-raise downstream
            stop_aware_put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    def consume():
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    return _PrefetchIterator(consume())


class _PrefetchIterator:
    """Iterator wrapper marking prefetch-OWNED streams: consumers that
    finish early (fit() ending at `steps`, early stop) may close() it to
    stop the daemon producer deterministically; generic caller-owned
    generators must NOT be closed by fit (a second fit() on the same
    loader would silently train zero steps)."""

    _ravqa_prefetch_owned = True

    def __init__(self, gen):
        self._gen = gen

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._gen)

    def close(self):
        self._gen.close()


def _to_device(value, device: torch.device):
    """A numeric numpy array or tensor -> a tensor on `device` (through
    pinned memory with a non_blocking copy for a CUDA device); anything
    else (lists of strings or ids) passes through."""
    if isinstance(value, np.ndarray) and value.dtype.kind in "biuf":
        value = torch.from_numpy(value)
    if not isinstance(value, torch.Tensor):
        return value
    if device.type == "cuda":
        return value.pin_memory().to(device, non_blocking=True)
    return value.to(device)


def prefetch_to_device(batches: Iterable, size: int = 2,
                       device="cuda") -> Iterator:
    """prefetch() plus early device dispatch: each dict batch's arrays are
    copied to `device` from the producer thread, so the copies overlap the
    step in flight."""
    device = torch.device(device)

    def to_dev(b):
        if isinstance(b, dict):
            return {k: _to_device(v, device) for k, v in b.items()}
        return _to_device(b, device)
    return prefetch(batches, size=size, transform=to_dev)
