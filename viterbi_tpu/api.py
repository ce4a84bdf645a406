"""L4 public API — the JAX twin of the DLL export surface
(viterbi.def:4-8): ``deconvolve``, ``rs_check_superframe``,
``initialize``, ``get_caps``, ``wake_up``.

Return-code contracts match the reference exactly:
  * ``deconvolve`` returns 0 on success; 1 when the safe-mode latch is
    set or an input that would have crashed the reference is detected
    (the vectored-exception-handler path, exc_handler.cpp:150-250);
    decoded MSB-first packed bytes are written into ``output``.
  * ``rs_check_superframe`` returns the total number of corrected byte
    errors, or -1 on the first uncorrectable codeword
    (rschecksf.cpp:85-92).
  * ``initialize`` re-reads the config and re-arms safe mode
    (dllmain.cpp:156-160).

Batched entry points (``deconvolve_batch``, ``rs_decode_blocks``) are
the accelerator's fast path; the scalar signatures exist for drop-in
behavioral parity and for the fault-injection tests.
"""

from __future__ import annotations

import threading

import numpy as np

from . import constants as C
from .runtime import calllog, dispatch, faults

_SAFE = faults.SAFE_MODE_RETVAL


def _buf_len(buf) -> int:
    """Element count of an output buffer: ndarray .size, or len() for
    plain buffers (bytearray, memoryview, list)."""
    n = getattr(buf, "size", None)
    return len(buf) if n is None else int(n)


def _buf_write(buf, sl: slice, values: np.ndarray) -> None:
    """Assign uint8 values into ``buf[sl]`` for ndarrays and plain
    byte buffers alike (bytearray slice assignment rejects ndarrays;
    feed it bytes)."""
    if isinstance(buf, np.ndarray):
        buf[sl] = values
    else:
        buf[sl] = bytes(np.ascontiguousarray(values))

# Per-thread result channel: the reference is re-entrant by design
# (decisions live on the caller's stack, README.md:56); concurrent
# Python callers must likewise never read each other's results.
_tls = threading.local()


def last_output() -> np.ndarray | None:
    """This thread's most recent ``deconvolve`` result (packed bytes)."""
    return getattr(_tls, "deco_out", None)


def last_rs_output() -> np.ndarray | None:
    """This thread's most recent ``rs_check_superframe`` data bytes."""
    return getattr(_tls, "rs_out", None)


def initialize(config_path: str | None = None) -> bool:
    """Re-init: clears the safe-mode latch, re-reads config, re-probes
    the backend. Safe to call any time (QIRX calls it on every receiver
    start)."""
    ok = dispatch.initialize(config_path)
    cfg = dispatch.state().config
    calllog.configure(cfg.log_calls, cfg.log_symbols)
    return ok


def get_caps() -> int:
    """Backend capability bitmask (analog of GetCPUCaps)."""
    return dispatch.get_caps()


#: Standard DAB audio bitrate ladder (kbit/s) pre-warmed by
#: ``wake_up(ladder=True)`` — the shapes a channel-hopping receiver hits.
DAB_LADDER_KBPS = (8, 32, 64, 96, 128, 192, 384)


def wake_up(framebits: int = 3072, batch: int = 1,
            ladder=False) -> None:
    """Pre-compile the decode path — the analog of WakeUpYMM's
    pre-warming of cold SIMD stages (dllmain.cpp:45-56); here the cold
    stage is XLA compilation.

    ``ladder=True`` warms every DAB bitrate in ``DAB_LADDER_KBPS`` at
    the given batch (a real receiver hops subchannels, and each new
    (framebits, batch) shape otherwise pays its compile on the first
    live frame); an iterable of kbit/s rates warms exactly those.
    Compiles also persist across restarts via the compile cache
    (config key ``compile_cache``)."""
    if ladder is None or ladder is False:
        rates = None
    elif ladder is True:
        rates = DAB_LADDER_KBPS
    else:
        # an explicit empty iterable warms nothing (it does NOT fall
        # back to the default single-shape warm); non-iterable scalars
        # (e.g. ladder=0) are a caller error, not "no ladder"
        try:
            rates = tuple(int(k) for k in ladder)
        except TypeError:
            raise TypeError(
                "ladder must be a bool or an iterable of kbit/s rates, "
                f"got {ladder!r}") from None
    if rates is None:
        syms = np.zeros((batch, C.RATE * (framebits + C.TAIL_BITS)),
                        dtype=np.int32)
        _decode_batch(syms, framebits)
        return
    for kbps in rates:
        fb = 24 * int(kbps)
        syms = np.zeros((batch, C.RATE * (fb + C.TAIL_BITS)),
                        dtype=np.int32)
        _decode_batch(syms, fb)


def _decode_arbitrary(symbols, framebits: int) -> np.ndarray:
    """Decode at any framebits — the reference-contract path for sizes
    off the byte/parity grid (chainback.inc:18-41 writes output[t>>3]
    per bit; a partial final byte holds the remaining bits MSB-aligned
    over zeros, see traceback.packbits_msb).

    Odd framebits note: the reference's ACS main loop runs
    (framebits+6)/2 step *pairs* (deconvolve.cpp:92 — integer floor), so
    for odd framebits the topmost decision word the chainback reads
    (decis[framebits+5]) is never written: its stack buffer is
    uninitialized (deconvolve.cpp:93) and the first decoded bit is
    undefined. We implement the well-defined idealization — the full
    framebits+6-step terminated trellis — which is what the golden
    oracle computes; even framebits are bit-exact to the reference
    either way.

    Performance is irrelevant here (no DAB framebits is off-grid —
    framebits = bitrate*24); the simple XLA forward + scan traceback
    keeps the contract.
    """
    import jax.numpy as jnp

    from .ops import acs, traceback

    nsteps = framebits + C.TAIL_BITS
    ns_even = nsteps + (nsteps % 2)
    syms = jnp.asarray(symbols, dtype=jnp.int32)[:, : C.RATE * nsteps]
    if ns_even != nsteps:
        # one zero-padded trailing step: decisions are causal, so
        # decisions[:nsteps] (all the chainback reads) are unchanged,
        # and the renorm cadence for t < nsteps is identical
        syms = jnp.pad(syms, ((0, 0), (0, C.RATE)))
    decisions, _ = acs.forward(syms, ns_even)
    return np.asarray(
        traceback.chainback_scan(decisions[:nsteps], framebits))


def _decode_batch(symbols: np.ndarray, framebits: int,
                  packed: bool = False) -> np.ndarray:
    """Dispatch a [B, 4*(framebits+6)] int array (or packed words, see
    ``deconvolve_batch``) through the selected variant. Returns
    uint8[B, ceil(framebits/8)] packed bytes."""
    import jax.numpy as jnp

    from .ops import decode

    if framebits % 8:
        if packed:
            symbols = np.ascontiguousarray(symbols, dtype=np.int32) \
                .view(np.uint8).reshape(symbols.shape[0], -1)
        return _decode_arbitrary(symbols, framebits)
    variant = dispatch.variant()
    # a host cast (wrapping): packed words may exceed int32's range
    syms = jnp.asarray(np.ascontiguousarray(symbols, dtype=np.int32))
    return np.asarray(decode.decode(
        syms, framebits, variant,
        block=dispatch.state().config.traceback_block, packed=packed))


@faults.guarded(_SAFE)
def deconvolve(framebits: int, symbols, input_length: int = 0,
               output: np.ndarray | None = None) -> int:
    """Decode one frame. Signature mirrors the DLL export
    (viterbi.h:113); ``input_length`` is unused there too.

    ``symbols``: array-like of >= 4*(framebits+6) soft symbols (only the
    low byte of each is significant). ``output``: optional uint8 buffer
    of >= ceil(framebits/8) bytes, written in place.

    Any framebits in [1, MAX_FRAMEBITS] is accepted, as in the
    reference; for framebits % 8 != 0 the final byte holds the
    remaining bits MSB-aligned over zero low bits (chainback.inc:18-41
    — see ``_decode_arbitrary`` for the exact derivation and the odd-
    framebits caveat). DAB traffic is always byte-granular
    (framebits = bitrate*24), so the off-grid path favors contract
    fidelity over speed.
    """
    if symbols is None or framebits is None:
        # the reference would fault on the null deref inside the kernel
        # (fault-injection test b, viterbi-benchmark.cpp:444-481)
        raise faults.CrashError("null symbol buffer")
    framebits = int(framebits)
    if framebits <= 0 or framebits > C.MAX_FRAMEBITS:
        raise faults.ValidationError(f"bad framebits {framebits}")
    syms = np.asarray(symbols).reshape(-1)
    if syms.size < C.RATE * (framebits + C.TAIL_BITS):
        raise faults.ValidationError("symbol buffer too short")
    if output is not None and _buf_len(output) < -(-framebits // 8):
        raise faults.ValidationError("output buffer too short")
    with calllog.record("deco", framebits=framebits) as rec:
        rec.capture_symbols(syms[: C.RATE * (framebits + C.TAIL_BITS)],
                            source=symbols)
        out = _decode_batch(syms[None, :], framebits)[0]
    if output is not None:
        _buf_write(output, slice(0, out.size), out)
    _tls.deco_out = out  # per-thread functional access (last_output())
    return 0


@faults.guarded((_SAFE, None))
def deconvolve_batch(framebits: int, symbols_batch,
                     packed: bool = False) -> tuple[int, np.ndarray]:
    """Batched decode: [B, 4*(framebits+6)] -> (0, uint8[B, ceil(fb/8)]).

    ``packed=True`` accepts the host-packed one-int32-per-trellis-step
    layout instead (int32[B, >= framebits+6], symbol j in byte j —
    ``ops.packing.pack_symbols_host``; the layout ``native/vitio.cpp``
    produces on ingest). It is a byte-reinterpret of the over-the-wire
    DAB symbol stream and ships 4x fewer bytes per call — the
    production ingest path. Every variant consumes it on the device.
    """
    if symbols_batch is None:
        raise faults.CrashError("null symbol buffer")
    framebits = int(framebits)
    if framebits <= 0 or framebits > C.MAX_FRAMEBITS:
        raise faults.ValidationError(f"bad framebits {framebits}")
    syms = np.asarray(symbols_batch)
    width = ((framebits + C.TAIL_BITS) if packed
             else C.RATE * (framebits + C.TAIL_BITS))
    if syms.ndim != 2 or syms.shape[1] < width:
        raise faults.ValidationError("bad symbol batch shape")
    with calllog.record("deco", framebits=framebits, batch=syms.shape[0],
                        packed=int(packed)) as rec:
        if packed:
            rec.capture_symbols(syms[:, :width], source=symbols_batch)
            out = _decode_batch(syms[:, :width], framebits, packed=True)
        else:
            out = _decode_batch(syms, framebits)
    return 0, out


@faults.guarded(-1)
def rs_check_superframe(p, start_ix: int = 0, rs_dims: int = 0,
                        out_vector: np.ndarray | None = None) -> int:
    """Check/correct a DAB+ superframe (rschecksf.cpp:64-93).

    ``p``: array-like of rs_dims*120 bytes, byte-interleaved. Corrected
    rs_dims*110 data bytes are written to ``out_vector`` if given (and
    exposed per-thread via ``last_rs_output()``). ``start_ix`` is
    accepted and ignored, as in the reference (rschecksf.cpp:69).

    On -1 (uncorrectable codeword) the reference has already scattered
    every corrected codeword *before* the failed one into the caller's
    buffer (rschecksf.cpp:74-88); bytes belonging to the failed and
    later codewords stay untouched. The same partial write happens
    here.
    """
    import jax.numpy as jnp

    from .ops import rs as rs_ops

    if p is None:
        # fault-injection test c: RScheckSuperframe(NULL, 0, 10, NULL)
        raise faults.CrashError("null superframe buffer")
    if not rs_dims or rs_dims < 0:
        raise faults.ValidationError(f"bad rs_dims {rs_dims}")
    rs_dims = int(rs_dims)
    buf = np.asarray(p).reshape(-1)
    if buf.size < rs_dims * C.RS_N:
        raise faults.ValidationError("superframe buffer too short")
    if out_vector is not None and \
            _buf_len(out_vector) < rs_dims * C.RS_KK:
        raise faults.ValidationError("output buffer too short")
    with calllog.record("rscs", rs_dims=rs_dims) as rec:
        rec.capture_symbols(buf[: rs_dims * C.RS_N], source=p)
        errors, out, n_ok = rs_ops.rs_check_superframe(
            jnp.asarray(buf[: rs_dims * C.RS_N], dtype=jnp.int32), rs_dims)
    errors = int(errors)
    out = np.asarray(out)
    if out_vector is not None:
        if errors != -1:
            _buf_write(out_vector, slice(0, out.size), out)
        else:
            # partial write: corrected prefix only, interleaved stride —
            # byte k of codeword j lives at out[j + k*rs_dims].
            n_ok = int(n_ok)
            src = out.reshape(C.RS_KK, rs_dims)
            if isinstance(out_vector, np.ndarray):
                # one fancy-index assignment — writes through views of
                # any contiguity AND any ndim (reshape(-1) of a
                # non-contiguous multi-dim view would copy and silently
                # lose the write, so flat positions are unraveled onto
                # the original array instead)
                idx = (np.arange(C.RS_KK)[:, None] * rs_dims
                       + np.arange(n_ok)[None, :]).ravel()
                vals = src[:, :n_ok].astype(np.uint8).ravel()
                if out_vector.ndim == 1:
                    out_vector[idx] = vals
                else:
                    out_vector[np.unravel_index(idx,
                                                out_vector.shape)] = vals
            else:
                # plain byte buffers only accept slice assignment
                end = rs_dims * C.RS_KK
                for j in range(n_ok):
                    _buf_write(out_vector, slice(j, end, rs_dims),
                               src[:, j])
    _tls.rs_out = out
    return errors
