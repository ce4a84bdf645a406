"""Loopback test channel: encoder + AWGN, the methodology twin of the
reference benchmark's self-checking loop (viterbi-benchmark.cpp:293-329,
636-670).

Soft symbols are offset-binary around 127.5 with gain 32 and clipping to
[0, 255]; the noise standard deviation is derived from Eb/N0 with the
rate adjustment ``esn0 = ebn0 + 10*log10(1/RATE)`` exactly as the
reference does (viterbi-benchmark.cpp:292-294). The RNG is NumPy's
(seeded) generator rather than MSVC ``rand()`` — parity with the
reference is statistical (BER/FER at the operating point), the bit-exact
contract is decoder-vs-golden-model, not channel-vs-channel.
"""

from __future__ import annotations

import numpy as np

from .. import constants as C

EBN0_DB = 3.0      # reference operating point (viterbi-benchmark.cpp:60)
GAIN = 32.0
OFFSET = 127.5
CLIP = 255


def noise_amplitude(ebn0_db: float = EBN0_DB, rate: int = C.RATE) -> float:
    """Signal amplitude for unit-variance noise at the given Eb/N0."""
    esn0 = ebn0_db + 10.0 * np.log10(1.0 / rate)
    return 1.0 / np.sqrt(0.5 / 10.0 ** (esn0 / 10.0))


def awgn_soft_symbols(hard: np.ndarray, rng: np.random.Generator,
                      ebn0_db: float = EBN0_DB) -> np.ndarray:
    """Map hard symbols {0,1} to noisy soft symbols uint32 in [0, 255]."""
    amp = noise_amplitude(ebn0_db)
    hard = np.asarray(hard)
    mean = np.where(hard != 0, amp, -amp)
    sample = OFFSET + GAIN * (mean + rng.standard_normal(hard.shape))
    return np.clip(sample, 0, CLIP).astype(np.uint32)


def encode_batch(bits: np.ndarray) -> np.ndarray:
    """``golden.encode`` vectorized over frames: uint8[B, framebits] ->
    uint8[B, 4*(framebits+6)] hard symbols, flush bits included.
    Symbol j of step i is the parity of the taps of generator j over
    bits i-6..i (zeros before the frame start and in the tail)."""
    bits = np.asarray(bits, dtype=np.uint8)
    B, n = bits.shape
    nsteps = n + C.TAIL_BITS
    padded = np.concatenate(
        [np.zeros((B, C.TAIL_BITS), np.uint8), bits,
         np.zeros((B, C.TAIL_BITS), np.uint8)], axis=1)
    out = np.zeros((B, nsteps, C.RATE), dtype=np.uint8)
    for j, poly in enumerate(C.POLYS):
        for k in range(C.K):
            if (poly >> k) & 1:
                out[:, :, j] ^= padded[:, C.TAIL_BITS - k:
                                       C.TAIL_BITS - k + nsteps]
    return out.reshape(B, C.RATE * nsteps)


def make_frames(nframes: int, framebits: int, seed: int = 0,
                ebn0_db: float = EBN0_DB):
    """Generate (data_bytes, soft_symbols) for ``nframes`` random frames.

    Returns ``bits``  uint8[nframes, framebits]   original data bits and
            ``syms``  uint32[nframes, 4*(framebits+6)] noisy soft symbols.
    """
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=(nframes, framebits), dtype=np.uint8)
    # one noise draw for the whole batch: the same stream, in the same
    # order, as a draw per frame
    return bits, awgn_soft_symbols(encode_batch(bits), rng, ebn0_db)


def ber_fer(decoded_bytes: np.ndarray, bits: np.ndarray):
    """Bit/frame error rates of packed decode output vs original bits.

    ``decoded_bytes``: uint8[nframes, framebits//8] MSB-first packed.
    """
    nframes, framebits = bits.shape
    ref = np.packbits(bits, axis=1)
    diff = np.unpackbits(decoded_bytes ^ ref, axis=1)
    bit_errs = diff.sum(axis=1)
    ber = bit_errs.sum() / (nframes * framebits)
    fer = np.count_nonzero(bit_errs) / nframes
    return float(ber), float(fer), int(bit_errs.sum())
