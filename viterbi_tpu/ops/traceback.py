"""Traceback (chainback) — serial-scan and block-parallel variants.

The reference's chainback is an inherently serial register walk
(chainback.inc:18-41, deconvolve.cpp:416-435): from state 0 at the end
of the terminated trellis, each step reads the decision bit of the
current state and hops to the predecessor ``(state >> 1) | (bit << 5)``;
the bit is the decoded data bit. SURVEY.md §7.3 calls out restructuring
this for a batched accelerator as a hard part.

Two implementations, both bit-exact vs. the golden model:

  * ``chainback_scan`` — a ``lax.scan`` walk, batch-parallel over frames
    but sequential over the ``framebits`` steps.
  * ``chainback_blocked`` — three-phase block decomposition: (1) compose
    per-step predecessor maps into per-block maps, parallel over blocks,
    (2) a short sequential scan over block boundary states, (3) re-walk
    every block in parallel given its entry state. Sequential depth drops
    from T to ~2*BLOCK + T/BLOCK while every phase stays vectorized.

Decision layout consumed here matches ops.acs: uint32[T, B, 2], bit s of
word s//32 = decision for state s.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import constants as C

import numpy as _np

# MSB first; a host constant (a module-level jnp array would initialize
# the XLA backend at import time, breaking jax.distributed.initialize)
_PACK_WEIGHTS = (1 << _np.arange(7, -1, -1, dtype=_np.int32))


def packbits_msb(bits: jax.Array) -> jax.Array:
    """[..., nbits] {0,1} ints -> [..., ceil(nbits/8)] uint8, MSB-first.

    A partial final byte is MSB-aligned with zero low bits — exactly the
    reference chainback's last-byte contract for framebits % 8 != 0
    (chainback.inc:18-41 / deconvolve.cpp ChainBack: the final write to
    output[t>>3] happens at the byte's lowest t, when the EndState
    register holds the remaining data bits in its top bits and zeros —
    shifted-down initial state — below), and np.packbits semantics.
    """
    nbits = bits.shape[-1]
    if nbits % 8:
        pad = [(0, 0)] * (bits.ndim - 1) + [(0, 8 - nbits % 8)]
        bits = jnp.pad(bits, pad)
    b = bits.reshape(*bits.shape[:-1], -1, 8)
    return (b * _PACK_WEIGHTS).sum(axis=-1).astype(jnp.uint8)


def _decision_bit(dec_words: jax.Array, state: jax.Array) -> jax.Array:
    """dec_words: [B, 2] uint32; state: [B] int32 -> bit [B] int32.

    Elementwise select over the two words instead of a per-element
    gather (take_along_axis)."""
    w = jax.lax.bitcast_convert_type(dec_words, jnp.int32)
    word = jnp.where(state >= 32, w[:, 1], w[:, 0])
    return (word >> (state & 31)) & 1


@partial(jax.jit, static_argnames=("framebits",))
def chainback_scan(decisions: jax.Array, framebits: int) -> jax.Array:
    """Serial-walk traceback. decisions: uint32[framebits+6, B, 2].

    Returns uint8[B, framebits//8] MSB-first packed data bits.
    """
    B = decisions.shape[1]
    # Steps 0..5 are never read (their bits predate the frame); walk
    # indices framebits+5 .. 6 == reversed(decisions[6:]).
    rev = jnp.flip(decisions[C.TAIL_BITS:C.TAIL_BITS + framebits], axis=0)

    def step(state, dec_t):
        k = _decision_bit(dec_t, state)
        state = (state >> 1) | (k << 5)
        return state, k

    # unroll: the body is a handful of vector ops; per-iteration loop
    # overhead otherwise dominates
    _, ks = jax.lax.scan(step, jnp.zeros(B, dtype=jnp.int32), rev,
                         unroll=8)
    bits = jnp.flip(ks, axis=0).T                     # [B, framebits]
    return packbits_msb(bits)


# ---------------------------------------------------------------------------
# Block-parallel traceback
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("framebits", "block"))
def chainback_blocked(decisions: jax.Array, framebits: int,
                      block: int = 64) -> jax.Array:
    """Block-parallel traceback, bit-exact vs ``chainback_scan``.

    ``framebits`` must be a multiple of ``block`` (DAB framebits are
    multiples of 24*32; callers pick a compatible block).

    Implementation note: the in-block step axis is walked with scans
    over ``dynamic_index_in_dim`` (phase 1 forward, phase 3
    ``reverse=True``) rather than ``flip(...).transpose(...)`` prologs,
    which skips two full-tensor materializations of the
    [nblocks, block, B, 64] predecessor maps.
    """
    assert framebits % block == 0
    nblocks = framebits // block
    B = decisions.shape[1]

    # Decision words stay packed ([nblocks, block, B, 2] u32); each scan
    # step expands only its own [nblocks, B, 64] predecessor map — the
    # materialized full map ([framebits, B, 64] int32) costs 32x the
    # decisions (19.3 GB at framebits 9216 x B=4096).
    dwords = decisions[C.TAIL_BITS:C.TAIL_BITS + framebits] \
        .astype(jnp.int32).reshape(nblocks, block, B, 2)
    states = jnp.arange(C.NUM_STATES, dtype=jnp.int32)
    t_seq = jnp.arange(block)

    def step_map(t):
        """Predecessor map of in-block step t: [nblocks, B, 64]."""
        w = jax.lax.dynamic_index_in_dim(dwords, t, axis=1,
                                         keepdims=False)
        word = w[..., states >> 5]
        k = (word >> (states & 31)) & 1
        return (states >> 1) | (k << 5)

    # Phase 1: per-block composed map (walking backward within a block),
    # parallel over blocks. comp[n, b, s] = state at block n's start given
    # state s at block n's end.
    #
    # Association order is the whole trick. The composition
    # m_t0 . m_t0+1 . ... . m_t0+63 can accumulate either as
    # step . comp (reverse iteration) or comp . step (forward
    # iteration). The first indexes the fresh step map BY the
    # accumulator — a data-dependent 64-way gather per element. The
    # second indexes the ACCUMULATOR by the step map m_t[s] =
    # (s>>1)|(k<<5), which takes only the two STATIC positions s>>1
    # and (s>>1)+32 per output lane — so the whole compose is two
    # static repeats and one select, no gather, bit-identical comp.
    def compose(comp, t):
        # comp: [nblocks, B, 64]; comp_new[s] = comp[m_t[s]]
        w = jax.lax.dynamic_index_in_dim(dwords, t, axis=1,
                                         keepdims=False)
        word = w[..., states >> 5]
        k = (word >> (states & 31)) & 1
        lo = jnp.repeat(comp[..., :32], 2, axis=-1)   # comp[s>>1]
        hi = jnp.repeat(comp[..., 32:], 2, axis=-1)   # comp[(s>>1)+32]
        return jnp.where(k == 1, hi, lo), None

    ident = jnp.broadcast_to(jnp.arange(C.NUM_STATES, dtype=jnp.int32),
                             (nblocks, B, C.NUM_STATES))
    comp, _ = jax.lax.scan(compose, ident, t_seq)

    def row_pick(m2, state):
        """m2[r, state[r]] without a gather: masked sum over the
        64-wide last axis (one match per row)."""
        eq = state[:, None] == jnp.arange(C.NUM_STATES, dtype=jnp.int32)
        return jnp.sum(jnp.where(eq, m2, 0), axis=-1)

    # Phase 2: boundary states. Walk block maps from the last block
    # (end state 0) to the first; emitted y = state at the END of each
    # block, stacked in original order by the reverse scan.
    def boundary(state, comp_n):                       # state: [B]
        return row_pick(comp_n, state), state

    _, end_states = jax.lax.scan(boundary, jnp.zeros(B, dtype=jnp.int32),
                                 comp, reverse=True)   # [nblocks, B]

    # Phase 3: re-walk every block in parallel given its end state;
    # ks[t] lands at its in-block position directly (reverse scan).
    def walk(state, t):                                # state: [nblocks*B]
        m2 = step_map(t).reshape(nblocks * B, C.NUM_STATES)
        k = row_pick(m2, state) >> 5
        return (state >> 1) | (k << 5), k

    _, ks = jax.lax.scan(walk, end_states.reshape(-1), t_seq, reverse=True)
    # ks: [block, nblocks*B] in step order -> [B, framebits]
    bits = ks.reshape(block, nblocks, B).transpose(2, 1, 0)
    bits = bits.reshape(B, framebits)
    return packbits_msb(bits)
