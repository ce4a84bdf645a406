"""Stateful stream sessions — decode an *arriving* stream in chunks.

VERDICT r4 next #4: ``decode_stream`` needs the whole stream
materialized, but a receiver gets 24 ms chunks forever. A
``StreamSession`` accepts symbol chunks as they arrive and emits
decoded bytes with bounded latency:

  * **exact metric carry**: path metrics at the emit boundary are the
    values a one-shot ACS from the stream start would have there
    (``initial_metrics`` plumbing; the boundary is kept on an even,
    24-aligned step so the renormalization cadence matches the global
    one) — unlike the reference, which resets metrics at every
    9216-bit call (deconvolve.cpp:97-100) and cannot span calls;
  * **truncated traceback**: each push decodes everything more than
    ``overlap`` steps behind the newest arrival, tracing back from the
    best end-metric state — the same overlap-truncation mechanism as
    block-overlap streaming, with the measured reliability of
    ``streaming.DEFAULT_OVERLAP`` (identical to one-shot for overlap
    >= 16 at the 3 dB DAB operating point; the default 120 leaves wide
    margin);
  * **one device call per push**: the pending symbols live host-side
    as packed 1-byte/symbol words (4x smaller uploads), the carried
    metrics live ON DEVICE between pushes, and the whole
    forward+lookahead+walk runs under a single jit — each push is one
    upload, one execute, one download.

Chunks may be any whole number of trellis steps (4 soft symbols per
step) with an even step count — every real DAB chunk (framebits =
bitrate*24 per 24 ms logical frame) satisfies this. Each distinct
(pending, chunk) step-count pair compiles once; fixed-size chunks
reach a steady state after the first push.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np

from .. import constants as C
from ..ops import acs
from ..ops.packing import pack_symbols_host, unpack_words
from .streaming import _anchored_chainback

EMIT_QUANTUM = 24   # emit boundaries land on multiples of 24 bits
                    # (byte-granular, and even for the renorm cadence)


@partial(jax.jit, static_argnames=("seg_a", "seg_b"))
def _push_compute(packed, init, seg_a: int, seg_b: int):
    """One device call per push: forward the emit region + lookahead,
    anchored-walk the emit region; returns (bytes, boundary metrics).

    ``packed``: int32[B, seg_a + seg_b] one-word-per-step symbols.
    """
    import jax.numpy as jnp

    segA = unpack_words(packed[:, :seg_a])
    segB = unpack_words(packed[:, seg_a:seg_a + seg_b])
    dec_a, m1 = acs.forward(segA, seg_a, initial_metrics=init)
    dec_b, m2 = acs.forward(segB, seg_b, initial_metrics=m1)
    best = jnp.argmin(m2, axis=1).astype(jnp.int32)
    # decisions carry a TAIL_BITS trellis delay (decision at step t
    # decides bit u[t-6]): the emit window's bits live in rows
    # [6, seg_a+6) of the concatenated history — exactly
    # _anchored_chainback's block windowing
    dec = jnp.concatenate([dec_a, dec_b], axis=0)
    anchor_j = jnp.full(packed.shape[0], seg_a + seg_b - 1, jnp.int32)
    out = _anchored_chainback(dec, anchor_j, best, seg_a + seg_b, seg_a)
    return out, m1


@partial(jax.jit, static_argnames=("rest",))
def _flush_compute(packed, init, rest: int):
    """Terminated-tail flush: decode the remaining ``rest`` bits
    anchored at state 0, in one device call. ``packed``: int32
    [B, rest + TAIL_BITS] one-word-per-step."""
    import jax.numpy as jnp

    nsteps = rest + C.TAIL_BITS
    dec, _ = acs.forward(unpack_words(packed), nsteps,
                         initial_metrics=init)
    anchor_j = jnp.full(packed.shape[0], nsteps - 1, jnp.int32)
    return _anchored_chainback(dec, anchor_j,
                               jnp.zeros(packed.shape[0], jnp.int32),
                               nsteps, rest)


class StreamSession:
    """Chunked-arrival decoder for one batch of parallel streams.

    ``push(symbols)`` ingests int[B, 4*n] soft symbols (n trellis
    steps, n even) and returns the newly decoded uint8[B, k] bytes
    (possibly k=0 while the lookahead fills). ``flush(tail_symbols)``
    ingests the 6-tail-bit symbols int[B, 24] of the terminated stream
    and returns every remaining byte. The concatenated output is
    bit-identical to a one-shot decode of the whole stream under the
    overlap-reliability envelope (see module docstring).
    """

    def __init__(self, batch: int, overlap: int = 120):
        if overlap < C.TAIL_BITS:
            raise ValueError(f"overlap {overlap} < {C.TAIL_BITS}")
        self.B = batch
        self.overlap = int(overlap)
        self.emitted_bits = 0                 # multiple of EMIT_QUANTUM
        self._metrics = None                  # device array (or None)
        self._buf = np.zeros((batch, 0), dtype=np.int32)  # packed words
        self._done = False

    def _init_metrics(self):
        if self._metrics is None:
            return acs.init_metrics(self.B)
        return self._metrics

    def pending_steps(self) -> int:
        """Trellis steps ingested but not yet emitted."""
        return self._buf.shape[1]

    def push(self, symbols) -> np.ndarray:
        """Ingest a chunk; return newly decoded bytes (uint8[B, k])."""
        import jax.numpy as jnp

        if self._done:
            raise RuntimeError("session already flushed")
        chunk = np.asarray(symbols)
        if chunk.ndim != 2 or chunk.shape[0] != self.B \
                or chunk.shape[1] % (2 * C.RATE):
            raise ValueError(
                f"chunk must be [batch={self.B}, 4*steps] with an even "
                f"step count, got {chunk.shape}")
        self._buf = np.concatenate(
            [self._buf, pack_symbols_host(chunk)], axis=1)
        avail = self.pending_steps()
        # emit everything more than `overlap` steps behind the newest
        # arrival, on EMIT_QUANTUM boundaries
        seg_a = ((avail - self.overlap) // EMIT_QUANTUM) * EMIT_QUANTUM
        if seg_a <= 0:
            return np.zeros((self.B, 0), dtype=np.uint8)
        seg_b = avail - seg_a                  # >= overlap, even
        out, m1 = _push_compute(
            jnp.asarray(self._buf[:, :avail]), self._init_metrics(),
            seg_a, seg_b)
        self._metrics = m1                     # stays on device
        self.emitted_bits += seg_a
        self._buf = self._buf[:, seg_a:]
        return np.asarray(out)

    def flush(self, tail_symbols) -> np.ndarray:
        """Ingest the 6 tail-bit symbols of the terminated stream and
        return all remaining decoded bytes (uint8[B, ceil(rest/8)])."""
        import jax.numpy as jnp

        if self._done:
            raise RuntimeError("session already flushed")
        tail = np.asarray(tail_symbols)
        if tail.ndim != 2 or tail.shape != (self.B,
                                            C.RATE * C.TAIL_BITS):
            raise ValueError(
                f"tail must be [batch={self.B}, {C.RATE * C.TAIL_BITS}]")
        self._done = True
        rest = self.pending_steps()
        if rest == 0:
            return np.zeros((self.B, 0), dtype=np.uint8)
        full = np.concatenate(
            [self._buf, pack_symbols_host(tail)], axis=1)
        out = _flush_compute(jnp.asarray(full), self._init_metrics(),
                             rest)
        self.emitted_bits += rest
        self._buf = np.zeros((self.B, 0), dtype=np.int32)
        return np.asarray(out)
