"""Tail-biting wrap decode — batched JAX twin of
``golden.tailbiting_decode`` (bit-exact by construction and by test).

The DAB mother code is terminated, so the reference has no tail-biting
path (SURVEY.md §2.1); this implements the north-star item with the
wrap-heuristic semantics defined by the golden model: uniform initial
metrics, warm-up ACS over the last ``wrap_steps`` steps, a full
recorded pass, best-end-state anchor (lowest metric, lowest index on
ties), and circular chainback where step t's decision yields data bit
(t - 6) mod framebits.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .. import constants as C
from . import acs
from .traceback import _decision_bit, packbits_msb


@partial(jax.jit, static_argnames=("framebits", "wrap_steps"))
def decode_tailbiting(symbols: jax.Array, framebits: int,
                      wrap_steps: int = 96) -> jax.Array:
    """Decode tail-biting frames: [B, >=4*framebits] int32 soft symbols
    -> uint8[B, framebits//8] MSB-first packed bytes. Bit-exact vs
    golden, including end-metric ties where the best path is not
    circularly consistent (the final 6 bits follow the circular
    convention: decision at step t is data bit (t - 6) mod framebits)."""
    assert wrap_steps % 2 == 0 and wrap_steps <= framebits
    B = symbols.shape[0]
    syms = symbols[:, : C.RATE * framebits].astype(jnp.int32)

    zero_init = jnp.zeros((B, C.NUM_STATES), dtype=jnp.int32)
    warm = syms[:, C.RATE * (framebits - wrap_steps):]
    _, metrics = acs.forward(warm, wrap_steps, initial_metrics=zero_init)

    decisions, metrics = acs.forward(syms, framebits,
                                     initial_metrics=metrics)
    anchor = jnp.argmin(metrics, axis=1).astype(jnp.int32)   # [B]

    def step(state, dec_t):
        k = _decision_bit(dec_t, state)
        return (state >> 1) | (k << 5), k

    _, ks = jax.lax.scan(step, anchor, jnp.flip(decisions, axis=0))
    bits_by_step = jnp.flip(ks, axis=0)          # [framebits, B], bit(t)
    # decision at step t is data bit (t - 6) mod framebits
    data_bits = jnp.roll(bits_by_step, -C.TAIL_BITS, axis=0)
    return packbits_msb(data_bits.T)
