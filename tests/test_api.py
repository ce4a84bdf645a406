"""API surface, dispatch, config, and fault-injection tests — the
behavioral twin of the reference benchmark's exception-handler checks
(viterbi-benchmark.cpp:444-481) plus config-override semantics
(setupdll.cpp:203-236)."""

import os

import numpy as np
import pytest

import viterbi_tpu
from viterbi_tpu import constants as C
from viterbi_tpu import golden
from viterbi_tpu.runtime import config as config_mod
from viterbi_tpu.runtime import dispatch


@pytest.fixture(autouse=True)
def _fresh_config(tmp_path, monkeypatch):
    monkeypatch.setenv(config_mod.CONFIG_ENV, str(tmp_path / "viterbi.txt"))
    viterbi_tpu.initialize()
    yield
    viterbi_tpu.initialize()


def test_deconvolve_single_frame_contract():
    framebits = 96
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, framebits, dtype=np.uint8)
    syms = golden.hard_to_soft(golden.encode(bits))
    out = np.zeros(framebits // 8, dtype=np.uint8)
    ret = viterbi_tpu.deconvolve(framebits, syms, 0, out)
    assert ret == 0
    assert np.array_equal(out, np.packbits(bits))


def test_fault_injection_latch_and_rearm():
    """Null input -> returns 1 and latches; initialize() re-arms
    (viterbi-benchmark.cpp:444-481)."""
    framebits = 96
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, framebits, dtype=np.uint8)
    syms = golden.hard_to_soft(golden.encode(bits))

    assert viterbi_tpu.deconvolve(0, None, 0, None) == 1  # "crash"
    assert dispatch.state().safe_mode
    # latched: even a good call now returns 1 immediately
    assert viterbi_tpu.deconvolve(framebits, syms) == 1
    # RS is latched too? No: RS latches independently via its own faults.
    viterbi_tpu.initialize()
    assert not dispatch.state().safe_mode
    assert viterbi_tpu.deconvolve(framebits, syms) == 0

    # RS null-pointer fault (test c in the reference)
    assert viterbi_tpu.rs_check_superframe(None, 0, 10, None) == -1
    assert dispatch.state().safe_mode
    viterbi_tpu.initialize()


def test_validation_error_does_not_latch():
    """A caller's shape typo returns the error code but must NOT latch
    safe mode for other callers — only faults attributed to our own
    kernels latch (the reference's address-range attribution,
    exc_handler.cpp:195,229-231)."""
    framebits = 96
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, framebits, dtype=np.uint8)
    syms = golden.hard_to_soft(golden.encode(bits))

    # out-of-range framebits: benign validation error (odd framebits
    # are accepted since round 5 — reference contract, chainback.inc)
    assert viterbi_tpu.deconvolve(C.MAX_FRAMEBITS + 1, syms) == 1
    assert not dispatch.state().safe_mode
    # too-short buffer: benign validation error
    assert viterbi_tpu.deconvolve(framebits, syms[:10]) == 1
    assert not dispatch.state().safe_mode
    # bad rs_dims: benign
    assert viterbi_tpu.rs_check_superframe(np.zeros(120, np.uint8),
                                           0, 0) == -1
    assert not dispatch.state().safe_mode
    # decoder still works, no re-init needed
    assert viterbi_tpu.deconvolve(framebits, syms) == 0


def test_concurrent_callers_get_own_results():
    """Two threads decoding different frames simultaneously must each
    read their own result — the re-entrancy contract (README.md:56:
    decisions on the caller's stack; QIRX v4 calls from multiple
    threads)."""
    import threading

    framebits = 96
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (2, framebits), dtype=np.uint8)
    syms = [golden.hard_to_soft(golden.encode(b)) for b in bits]
    expect = [np.packbits(b) for b in bits]
    # pre-compile both shapes to keep the race window in the decode path
    viterbi_tpu.deconvolve(framebits, syms[0])

    results = {}
    barrier = threading.Barrier(2)

    def worker(i):
        barrier.wait()
        for _ in range(5):
            out = np.zeros(framebits // 8, dtype=np.uint8)
            ret = viterbi_tpu.deconvolve(framebits, syms[i], 0, out)
            assert ret == 0
            assert np.array_equal(out, expect[i]), "in-place buffer raced"
            assert np.array_equal(viterbi_tpu.last_output(), expect[i]), \
                "thread-local result channel raced"
        results[i] = out

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert np.array_equal(results[0], expect[0])
    assert np.array_equal(results[1], expect[1])


def test_rs_superframe_api():
    rng = np.random.default_rng(5)
    rs_dims = 3
    msgs = rng.integers(0, 256, (rs_dims, C.RS_KK), dtype=np.uint8)
    cws = np.stack([golden.rs_encode_codeword(m) for m in msgs]).astype(np.int64)
    cws[0, 5] ^= 0x17
    p = cws.T.reshape(-1).astype(np.uint8)
    out = np.zeros(rs_dims * C.RS_KK, dtype=np.uint8)
    errors = viterbi_tpu.rs_check_superframe(p, 0, rs_dims, out)
    assert errors == 1
    assert np.array_equal(out.reshape(C.RS_KK, rs_dims).T, msgs)


def test_config_override_semantics(tmp_path, monkeypatch):
    """Downgrade always honored; unsupported upgrade ignored."""
    path = str(tmp_path / "cfg.txt")
    monkeypatch.setenv(config_mod.CONFIG_ENV, path)
    viterbi_tpu.initialize()
    auto = dispatch.state().variant
    # Force variant 0 (jax_scan) — a downgrade, must be honored.
    config_mod.write_variant(0)
    viterbi_tpu.initialize()
    assert dispatch.state().variant == 0
    # Force variant 2 (retired: no kernel anywhere) — keep automatic.
    config_mod.write_variant(2)
    viterbi_tpu.initialize()
    assert dispatch.state().variant == auto
    # '4' = auto-best alias.
    config_mod.write_variant(4)
    viterbi_tpu.initialize()
    assert dispatch.state().variant == auto


def test_config_template_and_show_info(tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "cfg.txt")
    monkeypatch.setenv(config_mod.CONFIG_ENV, path)
    cfg = config_mod.load()
    assert cfg.variant_override == -1  # template starts with 'a'
    with open(path) as f:
        content = f.read()
    content = "1:1" + content[3:]
    with open(path, "w") as f:
        f.write(content)
    viterbi_tpu.initialize()
    assert dispatch.state().variant == 1
    assert "variant=jax_blocked" in capsys.readouterr().out


def test_wake_up_ladder_and_compile_cache(tmp_path, monkeypatch):
    """wake_up(ladder=...) pre-compiles every requested DAB bitrate
    (dllmain.cpp:45-56's whole purpose, VERDICT r3 weak #6) and the
    config's compile_cache key controls JAX's persistent cache dir."""
    import jax

    path = str(tmp_path / "cfg.txt")
    cache_dir = str(tmp_path / "xla_cache")
    monkeypatch.setenv(config_mod.CONFIG_ENV, path)
    config_mod.ensure_config_file(path)
    with open(path, "a") as f:
        f.write(f"compile_cache={cache_dir}\n")
    prev_cache = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        viterbi_tpu.initialize()
        assert jax.config.jax_compilation_cache_dir == cache_dir
        assert os.path.isdir(cache_dir)
        # a pre-set cache dir is never clobbered
        jax.config.update("jax_compilation_cache_dir", str(tmp_path))
        viterbi_tpu.initialize()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev_cache)
    # warm a 2-rung ladder, then both shapes decode correctly
    viterbi_tpu.wake_up(batch=2, ladder=(8, 32))
    for kbps in (8, 32):
        fb = 24 * kbps
        bits = np.random.default_rng(kbps).integers(0, 2, fb,
                                                    dtype=np.uint8)
        syms = golden.hard_to_soft(golden.encode(bits))
        assert viterbi_tpu.deconvolve(fb, syms) == 0
        assert np.array_equal(viterbi_tpu.last_output(), np.packbits(bits))


def test_device_speed_test_runs_on_cpu():
    """The tuner's device-resident timing helper must run (and return a
    sane rate) for the XLA variants on the CPU backend."""
    from viterbi_tpu.harness import benchmark
    rate = benchmark.device_speed_test(1, loops=2, batch=4, framebits=96)
    assert rate > 0


def test_batch_decode_variants_agree():
    """Every decode variant this backend supports, selected through the
    real dispatch path, must produce identical, golden-exact decodes on
    identical noise (the reference's cross-ISA parity test,
    viterbi-benchmark.cpp:302,374)."""
    framebits = 192
    from viterbi_tpu.harness import channel
    bits, syms = channel.make_frames(3, framebits, seed=9)
    outs = {}
    caps = dispatch.get_caps()
    supported = [v for v in range(4) if dispatch._variant_supported(v, caps)]
    assert {0, 1} <= set(supported)
    for v in supported:
        config_mod.write_variant(v)
        viterbi_tpu.initialize()
        assert dispatch.state().variant == v
        ret, outs[v] = viterbi_tpu.deconvolve_batch(framebits, syms)
        assert ret == 0
    expect = np.stack([golden.deconvolve(framebits, s) for s in syms])
    for v in supported:
        assert np.array_equal(outs[v], expect), f"variant {v} mismatch"


def test_calllog_and_symbol_capture(tmp_path):
    from viterbi_tpu.runtime import calllog
    base = str(tmp_path / "log" / "trace")
    calllog.configure(True, True, base)
    framebits = 48
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, framebits, dtype=np.uint8)
    syms = golden.hard_to_soft(golden.encode(bits))
    assert viterbi_tpu.deconvolve(framebits, syms) == 0
    calllog.configure(False)
    log = open(base + ".log").read()
    assert "deco" in log and "framebits=48" in log
    import glob
    caps = glob.glob(str(tmp_path / "log" / "trace_sym" / "*.npy"))
    assert len(caps) == 1
    assert np.array_equal(np.load(caps[0]), syms[:4 * (framebits + 6)])


def test_non_multiple_of_six_framebits_decodes():
    """framebits like 64 (nsteps 70, no 6-divisor) must use the natural
    checkpoint period, not the front-pad path (code-review r3
    regression: the pad assert latched safe mode for framebits 64)."""
    framebits = 64
    bits = np.random.default_rng(2).integers(0, 2, framebits,
                                             dtype=np.uint8)
    syms = golden.hard_to_soft(golden.encode(bits))
    out = np.zeros(framebits // 8, dtype=np.uint8)
    assert viterbi_tpu.deconvolve(framebits, syms, 0, out) == 0
    assert not dispatch.state().safe_mode
    assert np.array_equal(out, np.packbits(bits))


def test_plain_buffer_outputs():
    """bytearray output buffers (no .size attribute) must pass the
    length validation and receive the decoded bytes / RS prefix."""
    framebits = 96
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, framebits, dtype=np.uint8)
    syms = golden.hard_to_soft(golden.encode(bits))
    buf = bytearray(framebits // 8)
    assert viterbi_tpu.deconvolve(framebits, syms, 0, buf) == 0
    assert bytes(buf) == np.packbits(bits).tobytes()

    # RS -1 path writes the prefix through a strided view of a plain
    # buffer and through a non-contiguous ndarray alike
    from viterbi_tpu import constants as C

    rs_dims = 3
    msgs = rng.integers(0, 256, (rs_dims, C.RS_KK), dtype=np.uint8)
    cws = np.stack([golden.rs_encode_codeword(m)
                    for m in msgs]).astype(np.int64)
    pos = rng.choice(C.RS_N, 9, replace=False)
    cws[1, pos] ^= rng.integers(1, 256, 9)      # codeword 1 uncorrectable
    inter = cws.T.reshape(-1).astype(np.uint8)
    ba = bytearray(b"\xee" * (rs_dims * C.RS_KK))
    assert viterbi_tpu.rs_check_superframe(inter, 0, rs_dims, ba) == -1
    view = np.frombuffer(bytes(ba), np.uint8).reshape(C.RS_KK, rs_dims).T
    assert np.array_equal(view[0], msgs[0])
    assert (view[1] == 0xEE).all() and (view[2] == 0xEE).all()

    big = np.full(2 * rs_dims * C.RS_KK, 0xEE, dtype=np.uint8)
    strided = big[::2]                           # non-contiguous view
    assert viterbi_tpu.rs_check_superframe(inter, 0, rs_dims, strided) == -1
    view2 = strided.reshape(C.RS_KK, rs_dims).T  # copy is fine for reading
    assert np.array_equal(view2[0], msgs[0])
    assert (view2[1] == 0xEE).all()


def test_partial_prefix_write_rs_dims_24():
    """-1 prefix write at production rs_dims through a non-contiguous
    ndarray view — regression for the vectorized fancy-index write
    (VERDICT r4 weak #5: the old per-codeword Python loop)."""
    rng = np.random.default_rng(11)
    rs_dims = 24
    msgs = rng.integers(0, 256, (rs_dims, C.RS_KK), dtype=np.uint8)
    cws = np.stack([golden.rs_encode_codeword(m)
                    for m in msgs]).astype(np.int64)
    fail_at = 7
    pos = rng.choice(C.RS_N, 9, replace=False)
    cws[fail_at, pos] ^= rng.integers(1, 256, 9)   # uncorrectable
    inter = cws.T.reshape(-1).astype(np.uint8)
    big = np.full(2 * rs_dims * C.RS_KK, 0xEE, dtype=np.uint8)
    strided = big[::2]                             # non-contiguous view
    assert viterbi_tpu.rs_check_superframe(inter, 0, rs_dims,
                                           strided) == -1
    view = strided.reshape(C.RS_KK, rs_dims).T     # copy; reading only
    for j in range(rs_dims):
        if j < fail_at:
            assert np.array_equal(view[j], msgs[j]), f"codeword {j}"
        else:
            assert (view[j] == 0xEE).all(), f"codeword {j} must be untouched"


def test_wake_up_rejects_bad_ladder():
    """ladder=0 (falsy non-bool) is a caller error with a descriptive
    TypeError, not an opaque iteration failure (advisor r4)."""
    with pytest.raises(TypeError, match="iterable of kbit/s"):
        viterbi_tpu.wake_up(ladder=0)
    viterbi_tpu.wake_up(framebits=48, ladder=())   # warms nothing, OK


def test_compile_cache_truthy_spellings(tmp_path, monkeypatch):
    """compile_cache=true must mean the default cache dir, not a
    directory literally named 'true' (advisor r4)."""
    p = tmp_path / "viterbi.txt"
    p.write_text("a:0\ncompile_cache=true\n")
    cfg = config_mod.load(str(p))
    assert cfg.compile_cache == config_mod.default_compile_cache_dir()
    p.write_text("a:0\ncompile_cache=no\n")
    assert config_mod.load(str(p)).compile_cache == ""
    p.write_text("a:0\ncompile_cache=/tmp/somewhere\n")
    assert config_mod.load(str(p)).compile_cache == "/tmp/somewhere"


def test_arbitrary_framebits_matches_golden():
    """The reference accepts ANY framebits (chainback.inc writes
    output[t>>3] per bit; partial final byte = remaining bits
    MSB-aligned over zeros). VERDICT r4 missing #1: the byte-granular
    restriction is lifted; every size matches the golden oracle."""
    rng = np.random.default_rng(3)
    for framebits in (1, 7, 9, 100, 9215):
        bits = rng.integers(0, 2, framebits, dtype=np.uint8)
        syms = golden.hard_to_soft(golden.encode(bits))
        expect = golden.deconvolve(framebits, syms)
        assert expect.size == -(-framebits // 8)
        out = np.zeros(expect.size, dtype=np.uint8)
        assert viterbi_tpu.deconvolve(framebits, syms, 0, out) == 0
        assert np.array_equal(out, expect), f"framebits={framebits}"
        assert np.array_equal(out, np.packbits(bits)), \
            f"partial-byte contract at framebits={framebits}"
        # noisy parity too (decisions actually exercised)
        from viterbi_tpu.harness import channel
        _, nsyms = channel.make_frames(2, framebits, seed=framebits)
        ret, nout = viterbi_tpu.deconvolve_batch(framebits, nsyms)
        assert ret == 0
        exp2 = np.stack([golden.deconvolve(framebits, s) for s in nsyms])
        assert np.array_equal(nout, exp2), f"noisy framebits={framebits}"
    # a short output buffer is still rejected at the ceil length
    from viterbi_tpu.runtime import faults
    bits = rng.integers(0, 2, 9, dtype=np.uint8)
    syms = golden.hard_to_soft(golden.encode(bits))
    assert viterbi_tpu.deconvolve(9, syms, 0,
                                  np.zeros(1, dtype=np.uint8)) == 1
    viterbi_tpu.initialize()


def test_calllog_thread_and_buffer_identity_tracing(tmp_path):
    """Thread first/last-seen rows (dllmain.cpp:260-307 analog) and
    buffer identity churn (deconvolve.cpp:625-628 analog) — VERDICT r4
    missing #2/#3."""
    import threading

    from viterbi_tpu.runtime import calllog

    base = str(tmp_path / "log" / "trace")
    calllog.configure(True, False, base)
    framebits = 48
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, framebits, dtype=np.uint8)
    syms = golden.hard_to_soft(golden.encode(bits))
    syms2 = syms.copy()                      # a second distinct buffer

    viterbi_tpu.deconvolve(framebits, syms)
    viterbi_tpu.deconvolve(framebits, syms)  # same buffer again
    viterbi_tpu.deconvolve(framebits, syms2)

    t = threading.Thread(
        target=lambda: viterbi_tpu.deconvolve(framebits, syms))
    t.start()
    t.join()

    s = calllog.summary()
    assert len(s["threads"]) == 2            # main + worker
    for trec in s["threads"].values():
        assert trec["last_seen"] >= trec["first_seen"]
        assert trec["calls"] >= 1
    deco = s["stats"]["deco"]
    assert deco["distinct_buffers"] == 2     # syms reused, syms2 fresh
    assert deco["addr_min"] <= deco["addr_max"]

    calllog.configure(False)
    log = open(base + ".log").read()
    assert log.count("first seen") >= 2      # attach lines per thread
    assert "buffer identity: 2 distinct arrays" in log
    assert "thread" in log and "last seen" in log


def test_ebno_sweep_golden_anchor():
    """The harness's absolute-BER anchor (golden equality at multiple
    Eb/N0 points) passes on the CPU backend at a small size."""
    from viterbi_tpu.harness import benchmark
    out = benchmark.ebno_sweep(points=(2.0, 4.0), frames=6, framebits=96)
    assert out["ok"], out
    assert set(out["points"]) == {"2.0", "4.0"}


def test_partial_prefix_write_multidim_noncontiguous():
    """Self-review r5 confirmed bug: a multi-dim non-contiguous
    out_vector's reshape(-1) copies, silently losing the -1 prefix
    write. The write must go through np.unravel_index instead."""
    rng = np.random.default_rng(12)
    rs_dims = 8
    msgs = rng.integers(0, 256, (rs_dims, C.RS_KK), dtype=np.uint8)
    cws = np.stack([golden.rs_encode_codeword(m)
                    for m in msgs]).astype(np.int64)
    pos = rng.choice(C.RS_N, 9, replace=False)
    cws[3, pos] ^= rng.integers(1, 256, 9)         # codeword 3 fails
    inter = cws.T.reshape(-1).astype(np.uint8)
    big = np.full((C.RS_KK, 20), 0xEE, dtype=np.uint8)
    out2d = big[:, :rs_dims]                       # non-contiguous 2-D
    assert viterbi_tpu.rs_check_superframe(inter, 0, rs_dims,
                                           out2d) == -1
    # row-major flat position j + k*rs_dims == out2d[k, j]
    for j in range(3):
        assert np.array_equal(out2d[:, j], msgs[j]), f"codeword {j}"
    assert (out2d[:, 3:] == 0xEE).all()
    assert (big[:, rs_dims:] == 0xEE).all()


def test_deconvolve_batch_packed_ingest():
    """deconvolve_batch(packed=True): the host-packed 1-byte/symbol
    production ingest layout decodes identically to the unpacked call
    on every supported variant, on and off the byte grid."""
    from viterbi_tpu.harness import channel
    from viterbi_tpu.ops import packing

    caps = dispatch.get_caps()
    for framebits in (96, 50):
        bits, syms = channel.make_frames(3, framebits, seed=19)
        syms = syms.astype(np.int32)
        expect = np.stack([golden.deconvolve(framebits, s) for s in syms])
        packed = packing.pack_symbols_host(syms)
        for v in range(4):
            if not dispatch._variant_supported(v, caps):
                continue
            config_mod.write_variant(v)
            viterbi_tpu.initialize()
            ret, out = viterbi_tpu.deconvolve_batch(framebits, packed,
                                                    packed=True)
            assert ret == 0
            assert np.array_equal(out, expect), f"variant {v}"
    # short packed buffer: validation error, not a crash
    viterbi_tpu.initialize()
    assert viterbi_tpu.deconvolve_batch(96, packed[:, :50],
                                        packed=True) == (1, None)
    viterbi_tpu.initialize()
