"""runtime.dispatch: the one place that decides which decode kernel
runs, the capability probe, and the compile-cache precedence."""

import os

import jax
import numpy as np
import pytest

import viterbi_tpu
from viterbi_tpu import golden
from viterbi_tpu.runtime import config as config_mod
from viterbi_tpu.runtime import dispatch


class _FakeDevice:
    def __init__(self, platform, cc=None):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        if cc is not None:
            self.compute_capability = cc


@pytest.fixture(autouse=True)
def _fresh_config(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "viterbi.txt"))
    yield
    monkeypatch.undo()
    viterbi_tpu.initialize()


@pytest.mark.parametrize("platform,cc,count,want", [
    ("cpu", None, 8, "jax_blocked"),
    ("gpu", "9.0", 1, "cuda_fused"),
    ("gpu", "8.0", 4, "jax_blocked"),
])
def test_variant_per_platform(monkeypatch, platform, cc, count, want):
    """Hopper GPUs get the fused kernel; every other backend the XLA
    blocked traceback. CAP_GPU / CAP_MULTI_DEVICE follow the devices."""
    devs = [_FakeDevice(platform, cc) for _ in range(count)]
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    caps = dispatch.get_caps()
    assert bool(caps & dispatch.CAP_GPU) == (platform == "gpu")
    assert bool(caps & dispatch.CAP_FUSED) == (want == "cuda_fused")
    assert bool(caps & dispatch.CAP_MULTI_DEVICE) == (count > 1)
    assert dispatch.best_variant() == want
    monkeypatch.setattr(dispatch, "apply_compile_cache", lambda cfg: None)
    dispatch.setup()
    assert dispatch.variant() == want


def test_forced_kernel_keeps_auto_where_unsupported(monkeypatch):
    """Config byte 0 is downgrade-only: '3' (cuda_fused) on a backend
    without the kernel and '2' (retired) anywhere keep the automatic
    choice; '0' is honored even on a Hopper GPU."""
    auto = dispatch.best_variant()
    for index in (2, 3):
        config_mod.write_variant(index)
        viterbi_tpu.initialize()
        assert dispatch.variant() == auto
    devs = [_FakeDevice("gpu", "9.0")]
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    monkeypatch.setattr(dispatch, "apply_compile_cache", lambda cfg: None)
    config_mod.write_variant(0)
    dispatch.setup()
    assert dispatch.variant() == "jax_scan"


def test_interpret_key_is_ignored():
    """The retired ``interpret=1`` key grants nothing: with no
    interpreted kernels left, the CPU gets the XLA variants only."""
    path = config_mod.ensure_config_file()
    assert "interpret" not in open(path).read()
    with open(path, "a") as f:
        f.write("interpret=1\n")
    config_mod.write_variant(3)
    viterbi_tpu.initialize()
    assert not dispatch.state().caps & dispatch.CAP_FUSED
    assert dispatch.variant() == "jax_blocked"


def test_broken_backend_raises(monkeypatch):
    """A backend that fails to start is an error, not an empty
    capability mask that quietly picks a CPU path."""
    def broken(*a):
        raise RuntimeError("backend init failed")
    monkeypatch.setattr(jax, "devices", broken)
    with pytest.raises(RuntimeError, match="backend init failed"):
        dispatch.get_caps()
    with pytest.raises(RuntimeError, match="backend init failed"):
        dispatch.setup()


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, initialize() sets no other
    directory, whatever the config says."""
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    path = config_mod.ensure_config_file()
    with open(path, "a") as f:
        f.write(f"compile_cache={tmp_path / 'cfg'}\n")
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        viterbi_tpu.initialize()
        assert jax.config.jax_compilation_cache_dir is None
        assert not (tmp_path / "cfg").exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_default_is_repo_dir(monkeypatch):
    """Unset env and no config key: the cache is <repo>/.jax_cache."""
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert config_mod.default_compile_cache_dir() == \
        os.path.join(repo, ".jax_cache")
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        viterbi_tpu.initialize()
        assert jax.config.jax_compilation_cache_dir == \
            os.path.join(repo, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


@pytest.mark.parametrize("variant", ["jax_scan", "jax_blocked"])
@pytest.mark.parametrize("framebits", [96, 200])
def test_decode_by_variant_matches_golden(variant, framebits):
    """ops.decode maps each XLA variant name to a golden-exact decode,
    including framebits that no 64-step traceback block divides."""
    import jax.numpy as jnp

    from viterbi_tpu.harness import channel
    from viterbi_tpu.ops import decode
    _, syms = channel.make_frames(3, framebits, seed=framebits)
    got = np.asarray(decode.decode(jnp.asarray(syms.astype(np.int32)),
                                   framebits, variant))
    assert np.array_equal(got, golden.deconvolve_batch(framebits, syms))


def test_decode_unknown_variant_raises():
    import jax.numpy as jnp

    from viterbi_tpu.ops import decode
    with pytest.raises(ValueError, match="no decode kernel"):
        decode.decode(jnp.zeros((1, 4 * 54), jnp.int32), 48, "retired")
