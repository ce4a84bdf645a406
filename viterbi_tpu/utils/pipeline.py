"""Host→device ingestion pipeline: keep the chip fed while the host
packs the next batch (SURVEY.md §7.3 "Host ingestion").

The reference receives symbols as in-process pointers from QIRX; an
accelerator consumes batches at a rate where host packing + transfer
must overlap device compute. JAX's dispatch is asynchronous, so the recipe is to
keep a bounded window of in-flight batches and only synchronize on the
oldest one:

    host pack/transfer of batch n+1..n+depth  ||  device decode of n

``device_put`` of the next batches is issued eagerly (transfer engines
run concurrently with compute); results are yielded oldest-first, so at
steady state the generator blocks only when the device is the
bottleneck.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator

import numpy as np


def decode_pipelined(batches: Iterable[np.ndarray],
                     decode_fn: Callable,
                     depth: int = 2) -> Iterator[np.ndarray]:
    """Stream batches through ``decode_fn`` with ``depth`` batches in
    flight.

    ``batches``: iterable of host arrays (any shape ``decode_fn``
    accepts). ``decode_fn``: a jitted device function. Yields one host
    ``np.ndarray`` result per input batch, in order.
    """
    import jax

    assert depth >= 1
    inflight: collections.deque = collections.deque()
    it = iter(batches)
    try:
        while True:
            while len(inflight) < depth:
                host = next(it)
                dev = jax.device_put(np.ascontiguousarray(host))
                inflight.append(decode_fn(dev))
            yield np.asarray(inflight.popleft())
    except StopIteration:
        pass
    while inflight:
        yield np.asarray(inflight.popleft())
