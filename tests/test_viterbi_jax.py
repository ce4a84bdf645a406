"""Bit-exact parity of the JAX batched Viterbi vs the golden oracle."""

import numpy as np
import pytest

from viterbi_tpu import constants as C
from viterbi_tpu import golden
from viterbi_tpu.harness import channel


def _jax_decode(framebits, syms_batch, blocked=False, block=64):
    import jax.numpy as jnp
    from viterbi_tpu.ops import acs, traceback
    decs, metrics = acs.forward(jnp.asarray(syms_batch.astype(np.int32)),
                                framebits + C.TAIL_BITS)
    if blocked:
        out = traceback.chainback_blocked(decs, framebits, block=block)
    else:
        out = traceback.chainback_scan(decs, framebits)
    return np.asarray(out), np.asarray(metrics)


@pytest.mark.parametrize("framebits", [48, 768])
def test_forward_metrics_and_decisions_match_golden(framebits):
    bits, syms = channel.make_frames(3, framebits, seed=11)
    import jax.numpy as jnp
    from viterbi_tpu.ops import acs
    decs, metrics = acs.forward(jnp.asarray(syms.astype(np.int32)),
                                framebits + C.TAIL_BITS)
    decs, metrics = np.asarray(decs), np.asarray(metrics)
    for i in range(3):
        g_dec, g_metrics = golden.viterbi_forward(framebits, syms[i])
        assert np.array_equal(metrics[i], g_metrics), f"frame {i} metrics"
        # Unpack our words and compare each step's 64 decision bits.
        w = decs[:, i, :].astype(np.int64)
        ours = ((w[:, 0][:, None] >> np.arange(32)) & 1)
        ours_hi = ((w[:, 1][:, None] >> np.arange(32)) & 1)
        full = np.concatenate([ours, ours_hi], axis=1).astype(np.uint8)
        assert np.array_equal(full, g_dec), f"frame {i} decisions"


@pytest.mark.parametrize("framebits", [96, 768, 3072])
def test_decode_bit_exact_vs_golden(framebits):
    bits, syms = channel.make_frames(4, framebits, seed=framebits)
    out, _ = _jax_decode(framebits, syms)
    for i in range(4):
        expect = golden.deconvolve(framebits, syms[i])
        assert np.array_equal(out[i], expect), f"frame {i}"


@pytest.mark.parametrize("block", [16, 32, 64, 96])
def test_blocked_traceback_matches_scan(block):
    framebits = 768
    bits, syms = channel.make_frames(4, framebits, seed=5)
    out_scan, _ = _jax_decode(framebits, syms, blocked=False)
    out_blk, _ = _jax_decode(framebits, syms, blocked=True, block=block)
    assert np.array_equal(out_scan, out_blk)


def test_noiseless_batch_roundtrip():
    framebits = 240
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (8, framebits), dtype=np.uint8)
    syms = np.stack([golden.hard_to_soft(golden.encode(b)) for b in bits])
    out, _ = _jax_decode(framebits, syms)
    assert np.array_equal(out, np.packbits(bits, axis=1))


def test_pack_symbols_host_matches_device():
    import jax.numpy as jnp
    from viterbi_tpu.ops import packing
    rng = np.random.default_rng(3)
    syms = rng.integers(0, 256, (3, 4 * 54), dtype=np.int32)
    want = np.asarray(packing.pack_symbols(jnp.asarray(syms), 54))
    assert np.array_equal(packing.pack_symbols_host(syms), want)


def test_unpack_words_inverts_packing():
    import jax.numpy as jnp
    from viterbi_tpu.ops import packing
    rng = np.random.default_rng(4)
    syms = rng.integers(0, 256, (2, 4 * 30), dtype=np.int32)
    words = jnp.asarray(packing.pack_symbols_host(syms))
    assert np.array_equal(np.asarray(packing.unpack_words(words)), syms)
