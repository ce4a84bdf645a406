"""Block-overlapped streaming Viterbi — the sequence-parallel (SP/CP)
analog for trellis decoding (SURVEY.md §2.7 row 3, §5 "long-context").

One long terminated symbol stream is split into ``n_seq`` time blocks
across the mesh's "seq" axis. Each device:

  1. runs a short warm-up ACS over the tail of its own block from
     uniform metrics (the decoder forgets its initial condition in
     ~5·K steps, so the resulting boundary metrics are effectively
     exact),
  2. hands those boundary metrics to its right neighbor with a
     ``ppermute`` over the device ring,
  3. re-runs ACS over its block *plus* an overlap region received from
     its right neighbor (symbols prefix, one more ``ppermute``), seeded
     with the received boundary metrics,
  4. traces back from the overlap end (best-metric state; the final
     block anchors at state 0 of the true termination) and keeps only
     its own block's bits — overlap truncation absorbs the anchor
     uncertainty.

Total communication: two ppermutes of [B, ...] tiles per stream,
regardless of stream length. No reference analog exists (the DLL
re-initializes metrics per 9216-bit frame); this is the mechanism for
streams ≫ MAX_FRAMEBITS.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from .. import constants as C
from ..ops import acs, traceback as tb
from . import mesh as mesh_mod

# Overlap is the truncation-reliability knob: a bit-error sweep (3.1
# Mbit per cell at 3072-bit blocks) showed streaming == whole-stream
# decode for overlap >= 16 at the 3 dB DAB operating point, >= 48 at
# 1.5 dB, and >= 120 at 0 dB. 120 costs 3.9% redundant compute per
# 3072-bit block and leaves a wide margin below the operating point.
DEFAULT_OVERLAP = 120  # steps; must be even and >= TAIL_BITS
WARMUP_STEPS = 128     # pass-1 ACS length for boundary-metric estimation
#   (same sweep, warmup axis at overlap 120: 64 still left mismatched
#   bits at 0 dB; 128 and 256 were both exactly clean)


def _uniform_metrics(batch: int) -> jax.Array:
    return jnp.full((batch, C.NUM_STATES), 63, dtype=jnp.int32)


def _anchored_chainback(decisions, anchor_j, anchor_state, tb_steps: int,
                        block_steps: int):
    """Walk ``decisions`` [tb_steps, B, 2] backward, forcing ``state =
    anchor_state`` when reaching decision index ``anchor_j``; emit data
    bits for indices [TAIL_BITS, TAIL_BITS + block_steps)."""
    B = decisions.shape[1]
    j_seq = jnp.arange(tb_steps - 1, -1, -1, dtype=jnp.int32)

    def step(state, inp):
        j, dec = inp
        state = jnp.where(j == anchor_j, anchor_state, state)
        k = tb._decision_bit(dec, state)
        return (state >> 1) | (k << 5), k

    # anchor_state * 0 keeps the device-varying type for the scan carry
    _, ks = jax.lax.scan(step, anchor_state * 0,
                         (j_seq, jnp.flip(decisions, axis=0)), unroll=8)
    bits = jnp.flip(ks, axis=0)                    # [tb_steps, B]
    body = bits[C.TAIL_BITS: C.TAIL_BITS + block_steps].T  # [B, block]
    return tb.packbits_msb(body)


def _plan_block_layout(blk: int, overlap, warmup):
    """Shared per-block layout planning for the sharded ring and the
    single-device virtual ring: validate block granularity, clamp the
    overlap, pick the warm-up length. Returns ``(overlap, warm)``.

    Raises descriptive ValueErrors for blocks too small for the
    mechanism ("use more data bits per device").
    """
    explicit = overlap is not None
    if overlap is None:
        overlap = DEFAULT_OVERLAP
    if blk % 8:
        raise ValueError(
            f"per-device block of {blk} bits is not byte-granular; "
            f"use more data bits per device")
    if not explicit and overlap > blk:
        # small per-device blocks: clamp the *default* overlap so short
        # streams keep working (truncation reliability degrades with
        # the block size anyway); an explicit overlap that doesn't fit
        # is a caller error and raises below
        overlap = blk - (blk % 2)
    if overlap % 2 or overlap < C.TAIL_BITS or overlap > blk:
        raise ValueError(
            f"overlap {overlap} does not fit the {blk}-bit per-device "
            f"block; use more data bits per device or a smaller overlap")
    warm = min(WARMUP_STEPS if warmup is None else warmup, blk)
    return overlap, warm


def make_stream_decoder(mesh, stream_bits: int,
                        overlap: int | None = None,
                        warmup: int | None = None):
    """Build a jitted sharded decoder for terminated streams of
    ``stream_bits`` data bits.

    ``overlap=None`` uses ``DEFAULT_OVERLAP``, clamped to fit small
    per-device blocks; an explicit overlap that cannot fit raises.

    Returns ``decode(symbols, tail_syms)`` where
      * ``symbols``: int32[B, 4*stream_bits] — the data-bit symbols,
      * ``tail_syms``: int32[B, 4*TAIL_BITS] — the flush-bit symbols,
    yielding uint8[B, stream_bits // 8] packed data bits.
    """
    n_seq = mesh.shape[mesh_mod.SEQ_AXIS]
    assert stream_bits % n_seq == 0
    tb_block = stream_bits // n_seq
    overlap, warm = _plan_block_layout(tb_block, overlap, warmup)

    right = [(d, d + 1) for d in range(n_seq - 1)]
    left = [(d, d - 1) for d in range(1, n_seq)]

    def _shard_body(syms, tail_syms):
        # syms: [B, 1, 4*tb_block] local block; tail_syms: [B, 4*6]
        syms = syms[:, 0, :]
        B = syms.shape[0]
        d = jax.lax.axis_index(mesh_mod.SEQ_AXIS)
        is_first = d == 0
        is_last = d == n_seq - 1

        # (1) warm-up ACS over the block tail -> boundary metrics
        init1 = jnp.where(is_first, acs.init_metrics(B), _uniform_metrics(B))
        if warm < tb_block:
            _, bmetrics = acs.forward(syms[:, -C.RATE * warm:], warm,
                                      initial_metrics=init1)
        else:
            _, bmetrics = acs.forward(syms, tb_block, initial_metrics=init1)
        # (2) boundary metrics ride the ring to the right
        recv_metrics = jax.lax.ppermute(bmetrics, mesh_mod.SEQ_AXIS, right)
        entry = jnp.where(is_first, acs.init_metrics(B), recv_metrics)
        # (3) overlap symbols from the right neighbor's prefix
        prefix = syms[:, : C.RATE * overlap]
        recv_prefix = jax.lax.ppermute(prefix, mesh_mod.SEQ_AXIS, left)
        tail_ext = jnp.concatenate(
            [tail_syms,
             jnp.zeros((B, C.RATE * (overlap - C.TAIL_BITS)), syms.dtype)],
            axis=1)
        ext = jnp.where(is_last, tail_ext, recv_prefix)
        full = jnp.concatenate([syms, ext], axis=1)
        hist, fmetrics = acs.forward(full, tb_block + overlap,
                                     initial_metrics=entry)

        # (4) anchored traceback; the final block anchors the terminated
        # end at state 0, the others at their best end state
        best = jnp.argmin(fmetrics, axis=1).astype(jnp.int32)
        anchor_state = jnp.where(is_last, jnp.zeros_like(best), best)
        anchor_j = jnp.where(is_last, tb_block + C.TAIL_BITS - 1,
                             tb_block + overlap - 1)
        out = _anchored_chainback(hist, anchor_j, anchor_state,
                                  tb_block + overlap, tb_block)
        return out[:, None, :]   # [B, 1, tb_block // 8]

    sharded = jax.shard_map(
        _shard_body, mesh=mesh,
        in_specs=(P(mesh_mod.DATA_AXIS, mesh_mod.SEQ_AXIS, None),
                  P(mesh_mod.DATA_AXIS, None)),
        out_specs=P(mesh_mod.DATA_AXIS, mesh_mod.SEQ_AXIS, None),
        # the scan carries mix seq-varying entry metrics with
        # data-varying symbols; the body is per-shard by construction
        check_vma=False)

    @jax.jit
    def decode(symbols, tail_syms):
        B = symbols.shape[0]
        blocks = symbols.astype(jnp.int32).reshape(
            B, n_seq, C.RATE * tb_block)
        out = sharded(blocks, tail_syms.astype(jnp.int32))
        return out.reshape(B, stream_bits // 8)

    return decode


def make_local_stream_decoder(stream_bits: int, n_blocks: int,
                              overlap: int | None = None,
                              warmup: int | None = None):
    """Single-device block-overlapped streaming: the same warm-up /
    boundary-metric / overlap-truncation mechanism as the sharded ring,
    but with the ``n_blocks`` time blocks folded into the batch axis of
    ONE device and the "ring" exchanges becoming batch-axis shifts.

    This is how ONE device decodes a stream ≫ MAX_FRAMEBITS without the
    serial T-step trellis: all blocks' ACS runs in parallel as a
    (B * n_blocks)-frame batch (the decoder's sequential dependence is
    broken by the same 5K-step forgetting property the multi-device ring
    exploits). No reference analog — the DLL walks long streams
    serially per 9216-bit frame with metric resets at every boundary
    (deconvolve.cpp:97-100).

    Returns ``decode(symbols, tail_syms)``:
      * ``symbols``: int[B, 4*stream_bits], ``tail_syms``: int[B, 4*6]
      -> uint8[B, stream_bits // 8].
    """
    assert stream_bits % n_blocks == 0
    blk = stream_bits // n_blocks
    overlap, warm = _plan_block_layout(blk, overlap, warmup)

    @jax.jit
    def decode(symbols, tail_syms):
        B = symbols.shape[0]
        N = B * n_blocks
        first = (jnp.arange(N, dtype=jnp.int32) % n_blocks) == 0
        last = (jnp.arange(N, dtype=jnp.int32) % n_blocks) == n_blocks - 1
        init1 = jnp.where(first[:, None], acs.init_metrics(N),
                          _uniform_metrics(N))

        flat = symbols.astype(jnp.int32).reshape(N, C.RATE * blk)
        prefix = flat[:, : C.RATE * overlap]
        nxt = jnp.roll(prefix.reshape(B, n_blocks, -1), -1, axis=1) \
            .reshape(N, -1)
        tail_ext = jnp.concatenate(
            [jnp.repeat(tail_syms.astype(jnp.int32), n_blocks, axis=0),
             jnp.zeros((N, C.RATE * (overlap - C.TAIL_BITS)), jnp.int32)],
            axis=1)
        ext = jnp.where(last[:, None], tail_ext, nxt)
        full = jnp.concatenate([flat, ext], axis=1)

        # (1) warm-up ACS over each block's tail -> boundary metrics
        if warm < blk:
            _, bmet = acs.forward(flat[:, -C.RATE * warm:], warm,
                                  initial_metrics=init1)
        else:
            _, bmet = acs.forward(flat, blk, initial_metrics=init1)

        # (2) "ring": block d's entry metrics come from block d-1 — a
        # batch-axis shift instead of a ppermute
        shifted = jnp.roll(bmet.reshape(B, n_blocks, -1), 1, axis=1) \
            .reshape(N, -1)
        entry = jnp.where(first[:, None], acs.init_metrics(N), shifted)

        # (3) full-block ACS over block + overlap from the entry metrics
        hist, fmet = acs.forward(full, blk + overlap, initial_metrics=entry)

        # (4) anchored traceback, overlap truncation
        best = jnp.argmin(fmet, axis=1).astype(jnp.int32)
        anchor_state = jnp.where(last, jnp.zeros_like(best), best)
        anchor_j = jnp.where(last, blk + C.TAIL_BITS - 1, blk + overlap - 1)
        out = _anchored_chainback(hist, anchor_j, anchor_state,
                                  blk + overlap, blk)
        return out.reshape(B, stream_bits // 8)

    return decode


def decode_stream(symbols, framebits: int, mesh=None,
                  overlap: int | None = None, warmup: int | None = None):
    """Convenience wrapper: ``symbols`` int[B, 4*(framebits+6)] for a
    terminated stream; splits data/tail symbols and decodes sharded."""
    if mesh is None:
        mesh = mesh_mod.make_mesh(n_data=1, n_seq=len(jax.devices()))
    symbols = jnp.asarray(symbols, dtype=jnp.int32)
    data_syms = symbols[:, : C.RATE * framebits]
    tail_syms = symbols[:, C.RATE * framebits: C.RATE * (framebits
                                                         + C.TAIL_BITS)]
    return make_stream_decoder(mesh, framebits, overlap,
                               warmup=warmup)(data_syms, tail_syms)
