"""Multi-process runtime initialization (the distributed-communication
backend slot of SURVEY.md §2.7 — the reference has none; here the
backend is the JAX distributed runtime + XLA collectives, which XLA
hands to NCCL on GPUs).

With several processes each runs the same program; ``initialize()``
wires them into one JAX runtime so ``jax.devices()`` spans every
process and the meshes built by ``parallel.mesh`` shard over every
device. Single-process environments (tests, one process driving all
the cards of a host) are a no-op.

Layout policy: within one host the cards are joined all to all by
NVLink, so a plain ``parallel.mesh.make_mesh`` fits any axis. Across
hosts the "data" axis (independent frames/subchannels, no
communication) should span the hosts and the "seq" axis
(block-overlapped streaming, ppermute boundary metrics) stay within a
host: ``make_multihost_mesh`` builds that layout.
"""

from __future__ import annotations

import os

import jax

from . import mesh as mesh_mod

_initialized = False

# Environment markers that indicate a real multi-process launch (the
# standard JAX cluster auto-detection inputs).
_CLUSTER_ENV = ("COORDINATOR_ADDRESS", "JAX_COORDINATOR_ADDRESS")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join the multi-host JAX runtime. Returns True if distributed mode
    is active (more than one process).

    A misconfigured explicit coordinator RAISES rather than silently
    degrading to single-process — a silent fallback would shard a
    multi-host job onto one host and look like a perf bug. Only the genuinely
    single-process case (no explicit args, no cluster environment) is
    a no-op.
    """
    global _initialized
    if _initialized:
        return jax.process_count() > 1
    explicit = coordinator_address is not None
    auto = any(os.environ.get(k) for k in _CLUSTER_ENV)
    if not explicit and not auto:
        return False          # single-process environment: nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)
    _initialized = True
    return jax.process_count() > 1


def make_multihost_mesh(n_seq_per_host: int = 1):
    """[data, seq] mesh over every process's devices: seq contiguous
    within a host, data spanning hosts (the no-communication axis)."""
    devices = jax.devices()
    n_seq = n_seq_per_host
    n_data = len(devices) // n_seq
    return mesh_mod.make_mesh(n_data=n_data, n_seq=n_seq, devices=devices)


def local_batch_slice(global_batch: int) -> slice:
    """The contiguous slice of a global frame batch this host feeds."""
    per = global_batch // jax.process_count()
    start = per * jax.process_index()
    return slice(start, start + per)
