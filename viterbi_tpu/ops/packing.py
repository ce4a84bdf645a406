"""Packed symbol layout: one int32 word per trellis step.

The DAB symbol stream arrives as four consecutive soft bytes per trellis
step, so packing is a byte-reinterpret on the host (little-endian,
symbol j in byte j) — the layout ``native/vitio.cpp`` produces on
ingest and ``api.deconvolve_batch(packed=True)`` accepts. It moves 4x
fewer bytes than one int32 per soft symbol.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def pack_symbols(symbols: jax.Array, nsteps: int) -> jax.Array:
    """[B, >=4*nsteps] soft symbols -> frame-major packed [B, nsteps]
    int32 (on device; only the low byte of each symbol is kept)."""
    s = symbols[:, : 4 * nsteps].astype(jnp.int32) & 0xFF
    s = s.reshape(symbols.shape[0], nsteps, 4)
    return (s[..., 0] | (s[..., 1] << 8) | (s[..., 2] << 16)
            | (s[..., 3] << 24))


def pack_symbols_host(symbols: np.ndarray) -> np.ndarray:
    """Host-side zero-arithmetic packing: [B, 4T] soft symbols (values
    0..255 in any integer dtype) -> [B, T] int32, one trellis step per
    word."""
    b, s4 = symbols.shape
    assert s4 % 4 == 0
    # zero-copy when frames already arrive as contiguous u8 (the
    # over-the-wire layout): astype would copy even u8->u8
    a = np.ascontiguousarray(symbols) if symbols.dtype == np.uint8 \
        else np.ascontiguousarray(symbols.astype(np.uint8))
    return a.view(np.int32).reshape(b, s4 // 4)


def unpack_words(pw: jax.Array) -> jax.Array:
    """[B, n] packed int32 (symbol q in byte q) -> [B, 4n] soft ints."""
    B, n = pw.shape
    s4 = jnp.stack([(pw >> (8 * q)) & 255 for q in range(4)], axis=-1)
    return s4.reshape(B, 4 * n)
