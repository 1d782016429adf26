"""Pipelined chunk-drain queue for the streamed counting drivers.

One shared implementation of the enqueue/drain pattern (previously
copy-pasted across four drivers, where the copies diverged on which
tuple index holds the capacity scalar): keep up to ``depth`` chunk
outputs in flight, queue the scalar outputs' device-to-host copies at
enqueue time, and drain the oldest output once the queue is full — so
by drain time the scalars have long arrived and the reads cost no round
trip.
"""

from __future__ import annotations

from collections import deque

__all__ = ["DrainQueue"]


class DrainQueue:
    """``push(out)`` enqueues one chunk's output tuple and prefetches
    the outputs at ``nu_index`` (an int or a tuple of ints — the
    capacity scalar plus any per-chunk tally scalars the drain reads);
    when more than ``depth`` outputs are in flight the oldest is passed
    to ``drain_fn``.  ``flush()`` drains the rest (in order)."""

    def __init__(self, drain_fn, nu_index, depth: int = 8):
        self._drain = drain_fn
        self._indices = (
            (nu_index,) if isinstance(nu_index, int) else tuple(nu_index)
        )
        self._depth = depth
        self._pending: deque = deque()

    def push(self, out) -> None:
        for i in self._indices:
            try:
                arr = out[i]
                # multi-process global arrays are not host-fetchable from
                # one process; the drain path allgathers them instead
                if getattr(arr, "is_fully_addressable", True):
                    arr.copy_to_host_async()
            except (AttributeError, NotImplementedError):
                pass
        self._pending.append(out)
        if len(self._pending) > self._depth:
            self._drain(self._pending.popleft())

    def flush(self) -> None:
        while self._pending:
            self._drain(self._pending.popleft())
