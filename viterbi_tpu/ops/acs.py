"""Batched Viterbi forward pass (add-compare-select) in pure JAX.

Batched reformulation of the reference's SIMD ACS kernels
(deconvolve.cpp:232-412, decon_avx2.asm:43-118): the 16/32-way SIMD
butterflies become a [batch, 64]-shaped vectorized butterfly; frame
batching replaces the host app's thread-level parallelism (SURVEY.md
§2.7). All arithmetic is int32 with explicit saturation, reproducing the
u8 saturating SIMD semantics bit-for-bit.

Trellis-step contract (SURVEY.md §2.1):
  * branch metric for butterfly b (predecessor states b and b+32, new
    states 2b / 2b+1):
      a_j = pol[j,b] ? 255 - s_j : s_j
      metric = (avg(avg(a_0,a_1), avg(a_2,a_3)) >> 2) & 63,
      avg(x,y) = (x+y+1) >> 1   (the rounding-``pavgb`` Karn trick)
  * ACS with saturating adds (cap 255), min survivor; decision = 1 iff
    the high-predecessor path wins, ties to 1 (cmpeq(min(m1,m0), m1))
  * renormalize after every 2nd step: if metric[state 0] > 150,
    saturating-subtract 63 from all metrics
  * initial metrics: state 0 -> 0, others -> 63.

Decisions are emitted packed as two uint32 words per (step, frame) —
bit s of word s//32 is the decision for new state s — the same layout as
the reference's ``decision_t`` (viterbi.h:89-92), which the traceback
consumes directly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C

# Polarity table baked in as a [4, 32] int32 constant.
_POL = np.asarray(C.branch_polarity_table(), dtype=np.int32)


def branch_metrics(syms4: jax.Array) -> jax.Array:
    """Branch metrics for one step. syms4: [..., 4] int32 -> [..., 32]."""
    s = (syms4 & 0xFF)[..., :, None]                      # [..., 4, 1]
    pol = jnp.asarray(_POL)                               # [4, 32]
    a = jnp.where(pol != 0, 255 - s, s)                   # [..., 4, 32]
    avg = lambda x, y: (x + y + 1) >> 1
    m = avg(avg(a[..., 0, :], a[..., 1, :]), avg(a[..., 2, :], a[..., 3, :]))
    return (m >> 2) & 63


def acs_step(metrics: jax.Array, m: jax.Array):
    """One trellis step. metrics: [B, 64], m: [B, 32] branch metrics.

    Returns (new_metrics [B, 64], decisions [B, 64] int32 in {0,1}).
    """
    cm = 63 - m
    lo = metrics[..., :32]
    hi = metrics[..., 32:]
    sat = lambda x: jnp.minimum(x, C.METRIC_MAX)
    p0e, p1e = sat(lo + m), sat(hi + cm)
    p0o, p1o = sat(lo + cm), sat(hi + m)
    even = jnp.minimum(p0e, p1e)
    odd = jnp.minimum(p0o, p1o)
    dec_e = (p1e <= p0e).astype(jnp.int32)
    dec_o = (p1o <= p0o).astype(jnp.int32)
    new = jnp.stack([even, odd], axis=-1).reshape(*metrics.shape)
    dec = jnp.stack([dec_e, dec_o], axis=-1).reshape(*metrics.shape)
    return new, dec


def pack_decisions(dec: jax.Array) -> jax.Array:
    """Pack [..., 64] {0,1} ints into [..., 2] uint32 decision words."""
    bits = dec.reshape(*dec.shape[:-1], 2, 32).astype(jnp.uint32)
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    return (bits * weights).sum(axis=-1, dtype=jnp.uint32)


def init_metrics(batch: int) -> jax.Array:
    m = jnp.full((batch, C.NUM_STATES), 63, dtype=jnp.int32)
    return m.at[:, 0].set(0)


@partial(jax.jit, static_argnames=("nsteps",))
def forward(symbols: jax.Array, nsteps: int,
            initial_metrics: jax.Array | None = None):
    """Run ``nsteps`` trellis steps over a batch of symbol streams.

    ``symbols``: [B, >=4*nsteps] int32 soft symbols (low byte significant).
    Returns (decisions uint32[nsteps, B, 2], final_metrics int32[B, 64]).

    ``nsteps`` must be even (framebits + 6 always is: framebits is a
    multiple of 24) so the renormalization cadence of the reference's
    2-steps-per-iteration main loop is preserved.
    """
    assert nsteps % 2 == 0, "nsteps must be even (renormalization cadence)"
    B = symbols.shape[0]
    syms = symbols[:, : C.RATE * nsteps].astype(jnp.int32)
    # [nsteps/2, B, 2, 4]: scan over step *pairs*, like the reference loop.
    syms = syms.reshape(B, nsteps // 2, 2, C.RATE).transpose(1, 0, 2, 3)
    metrics = init_metrics(B) if initial_metrics is None else initial_metrics

    def pair_step(metrics, syms_pair):
        m0 = branch_metrics(syms_pair[:, 0, :])
        metrics, dec0 = acs_step(metrics, m0)
        m1 = branch_metrics(syms_pair[:, 1, :])
        metrics, dec1 = acs_step(metrics, m1)
        renorm = metrics[:, 0:1] > C.RENORMALIZE_THRESHOLD
        metrics = jnp.where(renorm,
                            jnp.maximum(metrics - C.RENORM_SUB, 0), metrics)
        dec = jnp.stack([pack_decisions(dec0), pack_decisions(dec1)], axis=1)
        return metrics, dec                                # dec: [B, 2, 2]

    metrics, decs = jax.lax.scan(pair_step, metrics, syms)
    decisions = decs.transpose(0, 2, 1, 3).reshape(nsteps, B, 2)
    return decisions, metrics
