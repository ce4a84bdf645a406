"""Golden-model self-consistency: encoder, Viterbi oracle, RS oracle.

These tests pin the numerics contract of SURVEY.md §2.1/§2.2 that every
decode kernel is later diffed against.
"""

import numpy as np
import pytest

from viterbi_tpu import constants as C
from viterbi_tpu import golden
from viterbi_tpu.harness import channel


def test_polarity_table_matches_reference_constants():
    """The generated polarity table must reproduce const.asm:27-63."""
    pol = C.branch_polarity_table()
    # m128_1st_XOR_0_3_4_7 (butterflies 0..15, symbols 0 and 3):
    first_0347 = [0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0]
    # m128_2nd_XOR_0_3_4_7 (butterflies 16..31):
    second_0347 = [1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1]
    # m128_XOR_1_5 / m128_XOR_2_6 (same mask for both halves):
    xor_15 = [0, 1, 1, 0, 1, 0, 0, 1] * 2
    xor_26 = [0, 1, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0]
    assert pol[0, :16].tolist() == first_0347
    assert pol[0, 16:].tolist() == second_0347
    assert pol[3].tolist() == pol[0].tolist()  # g0 == g3
    assert pol[1, :16].tolist() == xor_15
    assert pol[1, 16:].tolist() == xor_15
    assert pol[2, :16].tolist() == xor_26
    assert pol[2, 16:].tolist() == xor_26


def test_encoder_known_vector():
    # All-zero input -> all-zero symbols.
    syms = golden.encode(np.zeros(16, dtype=np.uint8))
    assert syms.shape == (4 * 22,)
    assert not syms.any()
    # Single leading 1: first step has sr=1, symbols = parity(1 & poly) =
    # poly bit0 = 1 for all four generators (all polys odd).
    syms = golden.encode(np.array([1] + [0] * 15, dtype=np.uint8))
    assert syms[:4].tolist() == [1, 1, 1, 1]


@pytest.mark.parametrize("framebits", [48, 96, 768])
def test_noiseless_loopback_exact(framebits):
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, framebits, dtype=np.uint8)
    soft = golden.hard_to_soft(golden.encode(bits))
    decoded = golden.deconvolve(framebits, soft)
    assert np.array_equal(decoded, np.packbits(bits))


def test_noisy_loopback_ber():
    """BER at Eb/N0 = 3 dB must be small; FER sane (stat parity gate)."""
    framebits = 768
    bits, syms = channel.make_frames(40, framebits, seed=0)
    decoded = np.stack([golden.deconvolve(framebits, s) for s in syms])
    ber, fer, _ = channel.ber_fer(decoded, bits)
    assert ber < 5e-3  # catastrophic decoder failure would be ~0.5
    # At 3 dB the code should correct nearly everything in 40 frames.
    assert fer <= 0.5


def test_renormalization_on_long_frame():
    """A max-length frame forces many renormalizations; metrics stay u8."""
    framebits = 3072
    bits, syms = channel.make_frames(1, framebits, seed=3)
    decisions, metrics = golden.viterbi_forward(framebits, syms[0])
    assert metrics.max() <= 255 and metrics.min() >= 0
    decoded = golden.chainback(framebits, decisions)
    ber, _, _ = channel.ber_fer(decoded[None], bits)
    assert ber < 5e-3


def test_symbols_above_255_are_clamped():
    """Reference clamps syms to low byte (README:18-19, deconvolve.cpp:160)."""
    framebits = 48
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, framebits, dtype=np.uint8)
    soft = golden.hard_to_soft(golden.encode(bits)).astype(np.uint32)
    spiked = soft + 256 * rng.integers(0, 4, soft.shape).astype(np.uint32)
    assert np.array_equal(golden.deconvolve(framebits, spiked),
                          golden.deconvolve(framebits, soft))


# ---------------------------------------------------------------------------
# Reed-Solomon golden model
# ---------------------------------------------------------------------------


def test_gf_tables_basics():
    ato_mod, index_of = C.gf256_tables()
    assert index_of[0] == 255 and index_of[1] == 0
    assert ato_mod[0] == 1 and ato_mod[255] == 1  # alpha^255 == 1
    assert np.array_equal(ato_mod[:255], ato_mod[255:510])
    mul = C.gf256_mul_table()
    assert mul[0, 37] == 0 and mul[1, 37] == 37
    # alpha * alpha^254 = alpha^255 = 1
    a = int(ato_mod[1])
    assert mul[a, int(ato_mod[254])] == 1


def test_rs_roundtrip_no_errors():
    rng = np.random.default_rng(0)
    msg = rng.integers(0, 256, C.RS_KK, dtype=np.uint8)
    cw = golden.rs_encode_codeword(msg)
    count, corrected = golden.rs_decode_codeword(cw)
    assert count == 0
    assert np.array_equal(corrected[:C.RS_KK], msg)


@pytest.mark.parametrize("nerr", [1, 2, 3, 4, 5])
def test_rs_corrects_up_to_5_errors(nerr):
    rng = np.random.default_rng(nerr)
    msg = rng.integers(0, 256, C.RS_KK, dtype=np.uint8)
    cw = golden.rs_encode_codeword(msg).astype(np.int64)
    pos = rng.choice(C.RS_N, nerr, replace=False)
    cw[pos] ^= rng.integers(1, 256, nerr)
    count, corrected = golden.rs_decode_codeword(cw)
    assert count == nerr
    assert np.array_equal(corrected[:C.RS_KK], msg)


def test_rs_detects_uncorrectable():
    rng = np.random.default_rng(99)
    msg = rng.integers(0, 256, C.RS_KK, dtype=np.uint8)
    cw = golden.rs_encode_codeword(msg).astype(np.int64)
    pos = rng.choice(C.RS_N, 8, replace=False)  # 8 > 5 errors
    cw[pos] ^= rng.integers(1, 256, 8)
    count, _ = golden.rs_decode_codeword(cw)
    assert count == -1


def test_rs_superframe_interleaved():
    rs_dims = 3
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, 256, (rs_dims, C.RS_KK), dtype=np.uint8)
    cws = np.stack([golden.rs_encode_codeword(m) for m in msgs])
    cws_err = cws.astype(np.int64).copy()
    cws_err[1, 17] ^= 0x42
    cws_err[2, 115] ^= 0x99  # error in the parity region
    interleaved = cws_err.T.reshape(-1).astype(np.uint8)  # p[j + k*rs_dims]
    errors, out = golden.rs_check_superframe(interleaved, rs_dims)
    assert errors == 2
    out2 = out.reshape(C.RS_KK, rs_dims).T
    assert np.array_equal(out2, msgs)


@pytest.mark.parametrize("framebits", [96, 50, 768])
def test_deconvolve_batch_matches_scalar(framebits):
    """The frame-vectorized oracle is the scalar one, frame by frame."""
    _, syms = channel.make_frames(5, framebits, seed=framebits + 3)
    want = np.stack([golden.deconvolve(framebits, s) for s in syms])
    assert np.array_equal(golden.deconvolve_batch(framebits, syms), want)


def test_encode_batch_matches_golden_encoder():
    rng = np.random.default_rng(8)
    bits = rng.integers(0, 2, (4, 100), dtype=np.uint8)
    want = np.stack([golden.encode(b) for b in bits])
    assert np.array_equal(channel.encode_batch(bits), want)
