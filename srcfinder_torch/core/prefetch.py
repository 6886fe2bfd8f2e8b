"""Double-buffered block reading: a background thread reads block i+1
(and copies it towards the device) while block i is computed.

Port of the JAX package's ``core/prefetch.py::BlockPrefetcher``. On a CUDA
device each block is copied into page-locked host memory and sent with a
``non_blocking`` copy on a side stream; the consumer's stream waits on
that copy's event before it uses the block. The reader thread runs in a
copy of the caller's context, so spans it opens are children of the span
open around the loop.
"""

from __future__ import annotations

import contextvars
import queue
import threading
from typing import Callable

import numpy as np
import torch

__all__ = ["BlockPrefetcher"]

#: Blocks the reader thread holds ahead of the consumer.
DEPTH = 2

_DONE = object()


class BlockPrefetcher:
    """Iterate ``(i, block_i)`` for i in [0, nblocks), each block on
    ``device``, read :data:`DEPTH` blocks ahead in a background thread.

    ``read_fn(i)`` returns block i as a host array. An exception in
    ``read_fn`` is raised in the consumer. Leaving the loop early stops
    the reader.

    Usage::

        for i, blk in BlockPrefetcher(read_fn, nblocks, device="cuda"):
            out = compute(blk)
    """

    def __init__(self, read_fn: Callable[[int], np.ndarray], nblocks: int,
                 device="cpu"):
        self._read_fn = read_fn
        self._n = nblocks
        self._device = torch.device(device)

    def __len__(self):
        return self._n

    def _stage(self, arr, stream):
        """Host array -> (tensor on the device, event the copy records)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._device.type != "cuda":
            return t, None
        with torch.cuda.stream(stream):
            d = t.pin_memory().to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
        return d, event

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=DEPTH)
        stop = threading.Event()
        stream = (torch.cuda.Stream(self._device)
                  if self._device.type == "cuda" else None)

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return
                except queue.Full:
                    continue

        def producer():
            try:
                for i in range(self._n):
                    if stop.is_set():
                        return
                    put(self._stage(self._read_fn(i), stream))
                put(_DONE)
            except BaseException as e:      # handed to the consumer
                put(e)

        thread = threading.Thread(target=contextvars.copy_context().run, args=(producer,),
                                  name="block-prefetch", daemon=True)
        thread.start()
        try:
            for i in range(self._n + 1):
                item = q.get()
                if item is _DONE:
                    return
                if isinstance(item, BaseException):
                    raise item
                blk, event = item
                if event is not None:
                    cur = torch.cuda.current_stream(self._device)
                    cur.wait_event(event)
                    blk.record_stream(cur)
                yield i, blk
        finally:
            stop.set()
            thread.join()
