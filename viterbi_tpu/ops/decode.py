"""Batched frame decode by variant name — the one jittable body behind
``api.deconvolve_batch``, the DAB+ chain and the benchmarks. The name
comes from ``runtime.dispatch``; this module only maps it to kernels.
"""

from __future__ import annotations

from functools import partial

import jax

from .. import constants as C
from . import acs, packing, traceback


def pick_block(framebits: int, block: int = 64) -> int:
    """``block`` if it divides framebits, else the largest traceback
    block from a fixed ladder that does."""
    if framebits % block == 0:
        return block
    return next(b for b in (64, 48, 32, 24, 16, 8, 4, 2, 1)
                if framebits % b == 0)


@partial(jax.jit, static_argnames=("framebits", "variant", "block",
                                   "packed"))
def decode(symbols: jax.Array, framebits: int, variant: str,
           block: int = 64, packed: bool = False) -> jax.Array:
    """[B, 4*(framebits+6)] soft symbols (or, with ``packed``, [B,
    >=framebits+6] one-word-per-step int32) -> uint8[B, framebits/8].

    ``framebits`` must be even (a whole number of ACS step pairs);
    ``api`` routes other sizes to its scan path.
    """
    if variant == "cuda_fused":
        from . import cuda_fused
        return cuda_fused.decode(symbols, framebits, packed=packed)
    nsteps = framebits + C.TAIL_BITS
    if packed:
        symbols = packing.unpack_words(symbols[:, :nsteps])
    decisions, _ = acs.forward(symbols, nsteps)
    if variant == "jax_blocked":
        return traceback.chainback_blocked(
            decisions, framebits, block=pick_block(framebits, block))
    if variant == "jax_scan":
        return traceback.chainback_scan(decisions, framebits)
    raise ValueError(f"no decode kernel for variant {variant!r}")
