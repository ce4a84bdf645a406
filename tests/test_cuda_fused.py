"""The fused CUDA decode kernel (ops/cuda_fused.py).

On the CPU the kernel's per-frame C++ code is built for the host and run
through the same ``prepare``/``finish`` wrapper as the CUDA launch
(``cuda_fused.decode_host``), so its arithmetic, padding, layout and
packing are checked against the golden model here. The ``gpu``-marked
test runs the real kernel on a card.
"""

import numpy as np
import pytest

from viterbi_tpu import constants as C
from viterbi_tpu import golden
from viterbi_tpu.harness import channel
from viterbi_tpu.ops import cuda_fused, packing


@pytest.mark.parametrize("framebits", [48, 768, 3072, 9216])
def test_host_kernel_matches_golden(framebits):
    _, syms = channel.make_frames(2, framebits, seed=framebits)
    want = golden.deconvolve_batch(framebits, syms)
    got = cuda_fused.decode_host(syms.astype(np.int32), framebits)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("batch", [1, 33, 70])
def test_host_kernel_batch_not_multiple_of_warp(batch):
    """Batches off the warp and block granule: padded frames are
    computed and dropped, real frames are exact."""
    framebits = 96
    rng = np.random.default_rng(batch)
    syms = rng.integers(0, 256, (batch, C.RATE * (framebits + 6)),
                        dtype=np.int32)
    got = cuda_fused.decode_host(syms, framebits)
    assert got.shape == (batch, framebits // 8)
    assert np.array_equal(got, golden.deconvolve_batch(framebits, syms))


def test_host_kernel_packed_ingest():
    framebits = 192
    _, syms = channel.make_frames(5, framebits, seed=7)
    syms = syms.astype(np.int32)
    words = packing.pack_symbols_host(syms)
    got = cuda_fused.decode_host(words, framebits, packed=True)
    assert np.array_equal(got, cuda_fused.decode_host(syms, framebits))
    assert np.array_equal(got, golden.deconvolve_batch(framebits, syms))


@pytest.mark.parametrize("framebits", [1, 50, 9215])
def test_host_kernel_off_grid_framebits(framebits):
    """Any framebits: the final partial byte holds the remaining bits
    MSB-aligned over zeros, as golden (and the reference) emit."""
    _, syms = channel.make_frames(2, framebits, seed=framebits + 1)
    got = cuda_fused.decode_host(syms.astype(np.int32), framebits)
    assert got.shape == (2, -(-framebits // 8))
    assert np.array_equal(got, golden.deconvolve_batch(framebits, syms))


def test_prepare_layout_and_padding():
    """Time-major words, time padded to the prefetch block and the
    batch to a warp, zeros in the padding, symbol j in byte j."""
    import jax.numpy as jnp
    framebits, B = 50, 3
    nsteps = framebits + C.TAIL_BITS
    rng = np.random.default_rng(0)
    syms = rng.integers(0, 256, (B, C.RATE * nsteps), dtype=np.int32)
    w = np.asarray(cuda_fused.prepare(jnp.asarray(syms), framebits))
    assert w.dtype == np.uint32
    assert w.shape == (64, 32)                      # 56 -> 64, 3 -> 32
    s = syms.reshape(B, nsteps, 4).astype(np.uint32)
    want = s[..., 0] | s[..., 1] << 8 | s[..., 2] << 16 | s[..., 3] << 24
    assert np.array_equal(w[:nsteps, :B], want.T)
    assert not w[nsteps:].any() and not w[:, B:].any()
    pk = np.asarray(cuda_fused.prepare(
        jnp.asarray(packing.pack_symbols_host(syms)), framebits, packed=True))
    assert np.array_equal(pk, w)


def test_finish_byte_order():
    """Kernel words hold data bits MSB-first; bytes come out in
    np.packbits order, cut to ceil(framebits/8) and to the batch."""
    import jax.numpy as jnp
    words = np.zeros((2, 32), np.uint32)              # 2 words, Bp = 32
    words[0, 0], words[1, 0] = 0x01234567, 0x89ABCDEF
    words[0, 1] = 0xFFFFFFFF
    out = np.asarray(cuda_fused.finish(jnp.asarray(words), 44, 2))
    assert out.shape == (2, 6)
    assert out[0].tolist() == [0x01, 0x23, 0x45, 0x67, 0x89, 0xAB]
    assert out[1].tolist() == [0xFF] * 4 + [0, 0]


def test_build_failure_raises(monkeypatch, tmp_path):
    """No compiler, or a compiler that fails: BuildError with the
    command, never a silent fallback or a half-written library."""
    monkeypatch.setattr(cuda_fused, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_fused, "nvcc",
                        lambda: str(tmp_path / "no" / "nvcc"))
    with pytest.raises(cuda_fused.BuildError, match="nvcc"):
        cuda_fused.build_library()
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(cuda_fused.BuildError, match="failed"):
        cuda_fused.build_host_library()
    assert not list(tmp_path.iterdir())


def test_rebuild_when_source_changes(monkeypatch, tmp_path):
    """The library name carries a hash of the source: an unchanged
    source reuses the build, an edited one builds anew."""
    src = tmp_path / "k.cu"
    src.write_bytes(open(cuda_fused.SOURCE, "rb").read())
    monkeypatch.setattr(cuda_fused, "SOURCE", str(src))
    monkeypatch.setattr(cuda_fused, "BUILD_DIR", str(tmp_path / "build"))
    first = cuda_fused.build_host_library()
    assert cuda_fused.build_host_library() == first
    src.write_text(src.read_text() + "\n// edited\n")
    second = cuda_fused.build_host_library()
    assert second != first
    assert sorted(p.name for p in (tmp_path / "build").glob("*.so")) == \
        sorted([first.rsplit("/", 1)[1], second.rsplit("/", 1)[1]])


def test_decode_lowers_to_one_custom_call(monkeypatch):
    """Lowered for CUDA (no card needed): one FFI call on the padded
    time-major words, with the decisions scratch as a second result."""
    import jax
    import jax.numpy as jnp
    monkeypatch.setattr(cuda_fused, "_registered", True)
    x = jnp.zeros((40, C.RATE * 54), jnp.int32)
    text = jax.jit(lambda s: cuda_fused.decode(s, 48)).trace(x).lower(
        lowering_platforms=("cuda",)).as_text()
    assert text.count("custom_call @viterbi_fused_decode") == 1
    assert "(tensor<64x64xui32>) -> (tensor<2x64xui32>, " \
        "tensor<64x2x64xui32>)" in text


@pytest.mark.gpu
def test_gpu_kernel_matches_golden(gpu):
    import jax.numpy as jnp
    for framebits, B in ((3072, 300), (9216, 40), (50, 7)):
        _, syms = channel.make_frames(B, framebits, seed=framebits)
        syms = syms.astype(np.int32)
        got = np.asarray(cuda_fused.decode(jnp.asarray(syms), framebits))
        assert np.array_equal(got, golden.deconvolve_batch(framebits, syms))
