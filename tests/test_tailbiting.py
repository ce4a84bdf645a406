"""Tail-biting wrap decode: golden loopback and JAX parity."""

import numpy as np

from viterbi_tpu import golden


def test_golden_loopback_noiseless():
    framebits = 192
    rng = np.random.default_rng(0)
    for seed in range(4):
        bits = rng.integers(0, 2, framebits).astype(np.uint8)
        soft = golden.hard_to_soft(golden.encode_tailbiting(bits))
        out = golden.tailbiting_decode(framebits, soft, wrap_steps=96)
        assert (out == np.packbits(bits)).all()


def test_golden_loopback_light_noise():
    """A few flipped symbols still decode exactly (free distance)."""
    framebits = 384
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, framebits).astype(np.uint8)
    soft = golden.hard_to_soft(golden.encode_tailbiting(bits)).astype(np.int32)
    flips = rng.choice(soft.size, 8, replace=False)
    soft[flips] = 255 - soft[flips]
    out = golden.tailbiting_decode(framebits, soft, wrap_steps=96)
    assert (out == np.packbits(bits)).all()


def test_jax_matches_golden():
    import jax.numpy as jnp
    from viterbi_tpu.ops import tailbiting

    framebits, wrap = 192, 48
    rng = np.random.default_rng(2)
    B = 6
    syms = np.empty((B, 4 * framebits), np.int32)
    want = []
    for i in range(B):
        bits = rng.integers(0, 2, framebits).astype(np.uint8)
        soft = golden.hard_to_soft(
            golden.encode_tailbiting(bits)).astype(np.int32)
        # moderate corruption: the wrap heuristic's exact decisions
        # (anchor choice, tie-breaks) must still match bit-for-bit
        flips = rng.choice(soft.size, 40, replace=False)
        soft[flips] = rng.integers(0, 256, 40)
        syms[i] = soft
        want.append(golden.tailbiting_decode(framebits, soft,
                                             wrap_steps=wrap))
    out = tailbiting.decode_tailbiting(jnp.asarray(syms), framebits,
                                       wrap_steps=wrap)
    assert (np.asarray(out) == np.stack(want)).all()


def test_tailbiting_wrap_tie_regression():
    """A frame whose two best end states tie (48/49) with a circularly
    inconsistent best path once split a register-exchange decoder from
    golden by one bit: the golden convention dictates the wrapped head
    (the walk's start state). Frame preserved as a fixture; the decode
    must match golden exactly."""
    import os

    import jax.numpy as jnp

    from viterbi_tpu.ops import tailbiting

    framebits = 768
    syms = np.load(os.path.join(os.path.dirname(__file__), "data",
                                "tb_tie_syms.npy"))[None]
    want = golden.tailbiting_decode(framebits, syms[0], wrap_steps=96)
    out_x = tailbiting.decode_tailbiting(jnp.asarray(syms), framebits,
                                         wrap_steps=96)
    assert np.array_equal(np.asarray(out_x)[0], want)
