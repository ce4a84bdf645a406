"""Sharded decode on the virtual 8-device CPU mesh: data-parallel frame
batches and block-overlapped streaming with boundary-metric exchange."""

import numpy as np
import pytest

from viterbi_tpu import constants as C
from viterbi_tpu import golden
from viterbi_tpu.harness import channel


def test_data_parallel_sharded_decode_matches_golden():
    import jax
    from viterbi_tpu.parallel import batch, mesh as mesh_mod
    framebits = 192
    bits, syms = channel.make_frames(8, framebits, seed=21)
    mesh = mesh_mod.make_mesh()  # 8 devices on the data axis
    out = np.asarray(batch.decode_sharded(syms.astype(np.int32),
                                          framebits, mesh))
    expect = np.stack([golden.deconvolve(framebits, s) for s in syms])
    assert np.array_equal(out, expect)


@pytest.mark.parametrize("overlap", [None, 48])
@pytest.mark.parametrize("n_data,n_seq", [(1, 8), (2, 4)])
def test_streaming_matches_whole_decode(n_data, n_seq, overlap):
    """Streaming decode must be bit-equal to the whole-stream golden
    decode, with the default and a short explicit overlap."""
    from viterbi_tpu.parallel import mesh as mesh_mod, streaming
    framebits = 384 * n_seq          # per-device block 384 bits
    B = 2 * n_data
    bits, syms = channel.make_frames(B, framebits, seed=n_seq)
    mesh = mesh_mod.make_mesh(n_data=n_data, n_seq=n_seq)
    out = np.asarray(streaming.decode_stream(
        syms.astype(np.int32), framebits, mesh, overlap=overlap))
    expect = np.stack([golden.deconvolve(framebits, s) for s in syms])
    assert np.array_equal(out, expect)


def _whole_stream_decode(syms, stream_bits):
    """Whole-stream oracle at scales where the scalar golden model is
    impractical: the jitted XLA forward + blocked chainback, itself
    proven bit-exact vs golden across shapes (test_viterbi_jax)."""
    import jax
    import jax.numpy as jnp
    from viterbi_tpu.ops import acs, traceback as tb

    @jax.jit
    def whole(s):
        decisions, _ = acs.forward(s, stream_bits + C.TAIL_BITS)
        return tb.chainback_blocked(decisions, stream_bits, block=64)

    return np.asarray(whole(jnp.asarray(syms)))


@pytest.mark.parametrize("B,seed", [(64, 5), (8, 6)])
def test_streaming_production_scale_xla(B, seed):
    """Production shape: 3072 data bits per device x 8 devices, noisy
    3 dB frames — streaming must equal the whole-stream decode
    bit-for-bit."""
    from viterbi_tpu.parallel import mesh as mesh_mod, streaming
    stream_bits = 3072 * 8
    bits, syms = channel.make_frames(B, stream_bits, seed=seed)
    syms = syms.astype(np.int32)
    mesh = mesh_mod.make_mesh(n_data=1, n_seq=8)
    out = np.asarray(streaming.decode_stream(syms, stream_bits, mesh))
    assert np.array_equal(out, _whole_stream_decode(syms, stream_bits))


@pytest.mark.parametrize("block_bits,seed", [(64, 11), (48, 12)])
def test_streaming_small_blocks_clamp_default_overlap(block_bits, seed):
    """Per-device blocks smaller than DEFAULT_OVERLAP must clamp the
    default instead of asserting; an explicit oversized overlap still
    raises a descriptive error."""
    from viterbi_tpu.parallel import mesh as mesh_mod, streaming
    framebits = block_bits * 8       # tb_block < DEFAULT_OVERLAP 120
    bits, syms = channel.make_frames(4, framebits, seed=seed)
    mesh = mesh_mod.make_mesh(n_data=1, n_seq=8)
    out = np.asarray(streaming.decode_stream(
        syms.astype(np.int32), framebits, mesh))
    expect = np.stack([golden.deconvolve(framebits, s) for s in syms])
    assert np.array_equal(out, expect)
    with pytest.raises(ValueError, match="overlap"):
        streaming.decode_stream(syms.astype(np.int32), framebits, mesh,
                                overlap=96)


def test_streaming_noiseless_long_stream():
    from viterbi_tpu.parallel import mesh as mesh_mod, streaming
    framebits = 8 * 1024
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (1, framebits), dtype=np.uint8)
    syms = golden.hard_to_soft(golden.encode(bits[0]))[None]
    mesh = mesh_mod.make_mesh(n_data=1, n_seq=8)
    out = np.asarray(streaming.decode_stream(syms.astype(np.int32),
                                             framebits, mesh))
    assert np.array_equal(out, np.packbits(bits, axis=1))


def test_streaming_tiny_blocks_raise_descriptive_errors():
    """Blocks too small for the mechanism must raise the descriptive
    'use more data bits per device' error, not an opaque assert."""
    from viterbi_tpu.parallel import mesh as mesh_mod, streaming
    mesh = mesh_mod.make_mesh(n_data=1, n_seq=8)
    for framebits in (12 * 8, 30 * 8):
        bits, syms = channel.make_frames(2, framebits, seed=13)
        with pytest.raises(ValueError, match="more data bits per device"):
            streaming.decode_stream(syms.astype(np.int32), framebits, mesh)


@pytest.mark.parametrize("overlap", [None, 48])
def test_local_stream_decoder_matches_whole(overlap):
    """Single-device virtual-ring streaming (blocks folded into the
    batch axis): bit-equal to the whole-stream decode on noisy 3 dB
    frames, with the default and a short explicit overlap."""
    from viterbi_tpu.parallel import streaming
    n_blocks = 4
    stream_bits = 768 * n_blocks
    B = 2
    bits, syms = channel.make_frames(B, stream_bits, seed=31)
    syms = syms.astype(np.int32)
    dec = streaming.make_local_stream_decoder(stream_bits, n_blocks,
                                              overlap=overlap)
    out = np.asarray(dec(syms[:, :4 * stream_bits],
                         syms[:, 4 * stream_bits:]))
    assert np.array_equal(out, _whole_stream_decode(syms, stream_bits))


def test_local_stream_decoder_long_stream():
    """A 24576-bit stream (2.7x MAX_FRAMEBITS) through the local
    decoder — the one-device mechanism for streams the reference cannot
    represent in one call."""
    from viterbi_tpu.parallel import streaming
    n_blocks = 8
    stream_bits = 3072 * n_blocks
    bits, syms = channel.make_frames(2, stream_bits, seed=32)
    syms = syms.astype(np.int32)
    dec = streaming.make_local_stream_decoder(stream_bits, n_blocks)
    out = np.asarray(dec(syms[:, :4 * stream_bits],
                         syms[:, 4 * stream_bits:]))
    assert np.array_equal(out, _whole_stream_decode(syms, stream_bits))


@pytest.mark.parametrize("chunk_frames", [1, 5])
@pytest.mark.parametrize("overlap", [120, 48])
def test_stream_session_matches_one_shot(chunk_frames, overlap):
    """Chunked-arrival StreamSession: pushing 24 ms frames and flushing
    must reproduce the one-shot decode bit for bit on noisy 3 dB
    streams, for every chunk size and lookahead."""
    from viterbi_tpu.parallel.session import StreamSession
    framebits = 768
    n_frames = 10
    B = 2
    stream_bits = framebits * n_frames
    bits, syms = channel.make_frames(B, stream_bits, seed=41)
    syms = syms.astype(np.int32)
    data, tail = syms[:, :4 * stream_bits], syms[:, 4 * stream_bits:]

    sess = StreamSession(B, overlap=overlap)
    outs = []
    step = 4 * framebits * chunk_frames
    for i in range(0, data.shape[1], step):
        outs.append(sess.push(data[:, i:i + step]))
    outs.append(sess.flush(tail))
    got = np.concatenate(outs, axis=1)
    assert got.shape[1] == stream_bits // 8
    assert np.array_equal(got, _whole_stream_decode(syms, stream_bits))
    assert sess.emitted_bits == stream_bits
    with pytest.raises(RuntimeError):
        sess.push(data[:, :step])


def test_stream_session_tiny_pushes_and_validation():
    """Sub-frame pushes (any even step count) accumulate correctly; bad
    shapes raise descriptive errors."""
    from viterbi_tpu.parallel.session import StreamSession
    framebits = 480
    B = 2
    bits, syms = channel.make_frames(B, framebits, seed=43)
    syms = syms.astype(np.int32)
    data, tail = syms[:, :4 * framebits], syms[:, 4 * framebits:]
    sess = StreamSession(B)
    outs = []
    # irregular even-step chunks: 50, 96, 238, then the rest
    cuts = [0, 200, 584, 1536, data.shape[1]]
    for a, b in zip(cuts, cuts[1:]):
        outs.append(sess.push(data[:, a:b]))
    outs.append(sess.flush(tail))
    got = np.concatenate(outs, axis=1)
    expect = np.stack([golden.deconvolve(framebits, s) for s in syms])
    assert np.array_equal(got, expect)
    s2 = StreamSession(B)
    with pytest.raises(ValueError, match="even"):
        s2.push(np.zeros((B, 4), dtype=np.int32))      # odd step count
    with pytest.raises(ValueError, match="tail"):
        s2.flush(np.zeros((B, 7), dtype=np.int32))


def test_stream_session_custom_overlap():
    """A caller-tuned lookahead (overlap=48, the measured-reliable
    1.5 dB point) still reproduces the one-shot decode at 3 dB."""
    from viterbi_tpu.parallel import StreamSession
    framebits, n_frames, B = 768, 6, 2
    stream_bits = framebits * n_frames
    bits, syms = channel.make_frames(B, stream_bits, seed=51)
    syms = syms.astype(np.int32)
    sess = StreamSession(B, overlap=48)
    outs = []
    step = 4 * framebits
    for i in range(0, 4 * stream_bits, step):
        outs.append(sess.push(syms[:, i:i + step]))
    outs.append(sess.flush(syms[:, 4 * stream_bits:]))
    got = np.concatenate(outs, axis=1)
    assert np.array_equal(got, _whole_stream_decode(syms, stream_bits))
    with pytest.raises(ValueError, match="overlap"):
        StreamSession(B, overlap=4)
