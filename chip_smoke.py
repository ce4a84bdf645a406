"""Smoke test of the DAB decode chain on an NVIDIA GPU.

Drives the three user paths through their public entry points at sizes
a monitoring or headend site runs, and checks every result bit for bit
against ``viterbi_tpu.golden``:

  (a) ``deconvolve_batch`` at 128 kbit/s (framebits 3072) on 16384 noisy
      3 dB frames, with the int32 and the packed (``packed=True``)
      ingest;
  (b) every DAB bitrate (8..384 kbit/s) at B=2048 through the
      dispatcher, and an off-grid framebits (50) through ``deconvolve``;
  (c) the dispatched kernel against the XLA path (``acs.forward`` +
      ``chainback_blocked``): equality, and the time of each with the
      input upload counted, alternating kernel, XLA, XLA, kernel;
  (d) RS(120,110) on 65,536 codewords in three mixes (clean-dominated,
      all dirty, with uncorrectable codewords) and
      ``rs_check_superframe``;
  (e) the DAB+ chain (``models.dab.decode_ensemble_sharded``) on 512
      superframes;
  (f) one small call each of punctured EEP decode, tail-biting decode,
      ``StreamSession`` and ``make_local_stream_decoder``.

``--four`` runs only the four-card paths — the DAB+ chain on a 4-card
data mesh and ``streaming.decode_stream`` on a 4-deep and a 2x2 ring —
each against the one-card decode of the same input.

Usage: ``python chip_smoke.py [--four]`` from the repository root. It
exits non-zero, printing no result, unless JAX's backend is a GPU. Its
last stdout line is ``{"ok": true, "device": {"platform": ..., "kind":
..., "count": ...}}``, printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

DAB_KBPS = (8, 32, 64, 96, 128, 192, 384)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _sample(n: int, k: int, rng) -> np.ndarray:
    return np.sort(rng.choice(n, min(n, k), replace=False))


def phase_api(framebits: int = 3072, batch: int = 16384,
              sample: int = 256, seed: int = 1) -> dict:
    """(a) API decode of noisy frames, int32 and packed ingest."""
    import viterbi_tpu
    from viterbi_tpu import golden
    from viterbi_tpu.harness import channel
    from viterbi_tpu.ops import packing

    bits, syms = channel.make_frames(batch, framebits, seed=seed)
    syms = syms.astype(np.int32)
    ret, out = viterbi_tpu.deconvolve_batch(framebits, syms)
    check(ret == 0, f"deconvolve_batch returned {ret}")
    ret, outp = viterbi_tpu.deconvolve_batch(
        framebits, packing.pack_symbols_host(syms), packed=True)
    check(ret == 0, f"packed deconvolve_batch returned {ret}")
    check(np.array_equal(out, outp), "packed ingest differs from int32")
    idx = _sample(batch, sample, np.random.default_rng(seed))
    want = golden.deconvolve_batch(framebits, syms[idx])
    check(np.array_equal(out[idx], want),
          f"{int((out[idx] != want).any(axis=1).sum())} of {len(idx)} "
          f"sampled frames differ from golden")
    _, _, errs = channel.ber_fer(out, bits)
    return {"frames": batch, "golden_sample": len(idx),
            "bit_errors_at_3dB": errs}


def phase_ladder(kbps=DAB_KBPS, batch: int = 2048, sample: int = 32,
                 offgrid: int = 50, seed: int = 2) -> dict:
    """(b) every DAB bitrate through the dispatcher, plus an off-grid
    framebits through the single-frame ``deconvolve``."""
    import viterbi_tpu
    from viterbi_tpu import golden
    from viterbi_tpu.harness import channel

    rng = np.random.default_rng(seed)
    for k in kbps:
        fb = 24 * k
        _, syms = channel.make_frames(batch, fb, seed=seed + k)
        syms = syms.astype(np.int32)
        ret, out = viterbi_tpu.deconvolve_batch(fb, syms)
        check(ret == 0, f"{k} kbit/s: deconvolve_batch returned {ret}")
        idx = _sample(batch, sample, rng)
        check(np.array_equal(out[idx], golden.deconvolve_batch(fb, syms[idx])),
              f"{k} kbit/s differs from golden")
    _, syms = channel.make_frames(1, offgrid, seed=seed)
    out = np.zeros(-(-offgrid // 8), np.uint8)
    check(viterbi_tpu.deconvolve(offgrid, syms[0], 0, out) == 0,
          f"deconvolve({offgrid}) failed")
    check(np.array_equal(out, golden.deconvolve(offgrid, syms[0])),
          f"framebits {offgrid} differs from golden")
    return {"kbps": list(kbps), "batch": batch, "offgrid_framebits": offgrid}


def phase_kernel_vs_xla(shapes=((3072, 16384), (9216, 8192)),
                        variant: str | None = None, reps: int = 10,
                        seed: int = 3) -> dict:
    """(c) the dispatched kernel against the XLA path: equal outputs,
    and per-call time with the host->device upload counted, in turns
    kernel, XLA, XLA, kernel (each path warmed up first). The
    device-resident time (input already on the device) is reported
    beside it."""
    import jax

    from viterbi_tpu import constants as C
    from viterbi_tpu.ops import decode
    from viterbi_tpu.runtime import dispatch

    variant = variant or dispatch.variant()
    rng = np.random.default_rng(seed)
    res = {"variant": variant, "xla": "jax_blocked"}
    order = ("kernel", "xla", "xla", "kernel")
    for fb, B in shapes:
        host = rng.integers(0, 256, (B, C.RATE * (fb + C.TAIL_BITS)),
                            dtype=np.int32)
        fns = {name: jax.jit(lambda s, fb=fb, v=v: decode.decode(s, fb, v))
               for name, v in (("kernel", variant), ("xla", "jax_blocked"))}
        outs = {name: np.asarray(f(jax.device_put(host)))
                for name, f in fns.items()}
        check(np.array_equal(outs["kernel"], outs["xla"]),
              f"framebits {fb}: kernel != XLA")
        for f in fns.values():                     # settle allocations
            for _ in range(2):
                f(jax.device_put(host)).block_until_ready()
        dev = jax.device_put(host)
        for label, arg in (("upload", None), ("resident", dev)):
            times = {"kernel": [], "xla": []}
            for name in order:
                t0 = time.perf_counter()
                for _ in range(reps):
                    out = fns[name](jax.device_put(host) if arg is None
                                    else arg)
                out.block_until_ready()
                times[name].append((time.perf_counter() - t0) / reps * 1e3)
            res[f"fb{fb}_B{B}_ms_per_call_{label}"] = times
            log(f"  framebits {fb} B {B} ({label}): ms/call "
                f"kernel {times['kernel']} xla {times['xla']}")
        del dev
    return res


def _rs_mix(clean, rng, frac, max_errs, uncorrectable=0):
    """frac of codewords get 1..max_errs byte errors; the first
    ``uncorrectable`` get 9 (> t=5)."""
    from viterbi_tpu import constants as C
    cws = clean.copy()
    n = len(cws)
    pos = rng.random((n, C.RS_N)).argsort(axis=1)[:, :9]
    vals = rng.integers(1, 256, (n, 9))
    nerr = np.where(rng.random(n) < frac, rng.integers(1, max_errs + 1, n), 0)
    nerr[:uncorrectable] = 9
    use = np.arange(9)[None, :] < nerr[:, None]
    np.bitwise_xor.at(cws.reshape(-1),
                      (np.arange(n)[:, None] * C.RS_N + pos)[use], vals[use])
    return cws


def phase_rs(n_codewords: int = 65536, sample: int = 256, rs_dims: int = 48,
             seed: int = 4) -> dict:
    """(d) RS decode in three error mixes, sampled against golden, and
    ``rs_check_superframe`` (correctable and uncorrectable)."""
    import jax.numpy as jnp

    import viterbi_tpu
    from viterbi_tpu import constants as C
    from viterbi_tpu import golden
    from viterbi_tpu.ops import rs

    rng = np.random.default_rng(seed)
    msgs = rng.integers(0, 256, (256, C.RS_KK), dtype=np.uint8)
    base = np.stack([golden.rs_encode_codeword(m) for m in msgs])
    clean = np.tile(base, (-(-n_codewords // 256), 1))[:n_codewords] \
        .astype(np.int32)
    res = {}
    mixes = {"clean": (0.25, 1, 0), "dirty": (1.0, 5, 0),
             "uncorrectable": (0.25, 5, 64)}
    for name, (frac, max_errs, bad) in mixes.items():
        cws = _rs_mix(clean, rng, frac, max_errs, bad)
        count, corrected = rs.rs_decode_blocks(jnp.asarray(cws))
        count, corrected = np.asarray(count), np.asarray(corrected)
        idx = np.union1d(_sample(n_codewords, sample, rng),
                         np.arange(min(bad, n_codewords)))
        for i in idx:
            c, want = golden.rs_decode_codeword(cws[i])
            check(int(count[i]) == c, f"RS {name} codeword {i}: count "
                  f"{int(count[i])} != golden {c}")
            if c >= 0:
                check(np.array_equal(corrected[i], want),
                      f"RS {name} codeword {i} differs from golden")
        res[name] = {"uncorrectable": int((count < 0).sum()),
                     "corrected_bytes": int(count[count > 0].sum())}
    # superframe API: one correctable, one with an uncorrectable word
    for fail_at in (None, rs_dims // 2):
        cws = _rs_mix(clean[:rs_dims], rng, 1.0, 5)
        if fail_at is not None:
            pos = rng.choice(C.RS_N, 9, replace=False)
            cws[fail_at, pos] ^= rng.integers(1, 256, 9)
        p = cws.T.reshape(-1).astype(np.uint8)
        out = np.zeros(rs_dims * C.RS_KK, np.uint8)
        got = viterbi_tpu.rs_check_superframe(p, 0, rs_dims, out)
        want, want_out = golden.rs_check_superframe(p, rs_dims)
        check(got == want, f"rs_check_superframe {got} != golden {want}")
        ok = rs_dims if want >= 0 else fail_at
        mine = out.reshape(C.RS_KK, rs_dims)[:, :ok]
        check(np.array_equal(mine, want_out.reshape(C.RS_KK, rs_dims)[:, :ok]),
              "rs_check_superframe output differs from golden")
    return res


def _superframes(n: int, bitrate: int, rng, ebn0_db: float = 3.0):
    """n DAB+ superframes of RS-encoded audio, convolutionally encoded
    and sent through the AWGN channel: (audio, symbols)."""
    from viterbi_tpu import constants as C
    from viterbi_tpu import golden
    from viterbi_tpu.harness import channel
    from viterbi_tpu.models import dab

    cfg = dab.SubchannelConfig(bitrate)
    audio = rng.integers(0, 256, (n, cfg.rs_dims, C.RS_KK), dtype=np.uint8)
    cws = np.stack([golden.rs_encode_codeword(m)
                    for m in audio.reshape(-1, C.RS_KK)]) \
        .reshape(n, cfg.rs_dims, C.RS_N).astype(np.uint8)
    frames = np.unpackbits(cws.transpose(0, 2, 1).reshape(n, -1), axis=1) \
        .reshape(n * dab.SUPERFRAME_FRAMES, cfg.framebits)
    syms = channel.awgn_soft_symbols(channel.encode_batch(frames), rng,
                                     ebn0_db)
    return audio, syms.reshape(n, dab.SUPERFRAME_FRAMES, -1).astype(np.int32)


def _golden_chain(syms: np.ndarray, bitrate: int):
    """Golden Viterbi + golden RS superframe check of each superframe."""
    from viterbi_tpu import constants as C
    from viterbi_tpu import golden
    from viterbi_tpu.models import dab

    cfg = dab.SubchannelConfig(bitrate)
    n = syms.shape[0]
    fb = golden.deconvolve_batch(cfg.framebits, syms.reshape(
        n * dab.SUPERFRAME_FRAMES, -1)).reshape(n, -1)
    res = [golden.rs_check_superframe(sf, cfg.rs_dims) for sf in fb]
    return (np.array([e for e, _ in res]),
            np.stack([o for _, o in res]).reshape(n, C.RS_KK * cfg.rs_dims))


def phase_chain(n_superframes: int = 512, bitrate: int = 128,
                sample: int = 8, seed: int = 5) -> dict:
    """(e) the DAB+ chain on one device, against the golden chain."""
    from viterbi_tpu import constants as C
    from viterbi_tpu.models import dab
    from viterbi_tpu.parallel import mesh as mesh_mod

    import jax

    rng = np.random.default_rng(seed)
    audio, syms = _superframes(n_superframes, bitrate, rng)
    mesh1 = mesh_mod.make_mesh(n_data=1, n_seq=1, devices=jax.devices()[:1])
    out, errs = dab.decode_ensemble_sharded(syms, bitrate, mesh1)
    out, errs = np.asarray(out), np.asarray(errs)
    rs_dims = dab.SubchannelConfig(bitrate).rs_dims
    good = errs >= 0
    got = out.reshape(n_superframes, C.RS_KK, rs_dims).transpose(0, 2, 1)
    check(np.array_equal(got[good], audio[good]),
          "corrected superframes differ from the transmitted audio")
    idx = _sample(n_superframes, sample, rng)
    want_err, want_out = _golden_chain(syms[idx], bitrate)
    check(np.array_equal(errs[idx], want_err),
          f"RS error counts {errs[idx]} != golden {want_err}")
    ok = want_err >= 0
    check(np.array_equal(out[idx][ok], want_out[ok]),
          "chain output differs from golden")
    return {"superframes": n_superframes, "bitrate_kbps": bitrate,
            "uncorrectable": int((~good).sum()),
            "corrected_bytes": int(errs[good].sum())}


def phase_reach(seed: int = 6) -> dict:
    """(f) one small call of each remaining user path."""
    import jax.numpy as jnp

    from viterbi_tpu import golden
    from viterbi_tpu.harness import channel
    from viterbi_tpu.models import dab, puncture
    from viterbi_tpu.ops import tailbiting
    from viterbi_tpu.parallel import StreamSession, streaming

    rng = np.random.default_rng(seed)
    # punctured EEP 3-A at 64 kbit/s
    bitrate, level = 64, 3
    fb = 24 * bitrate
    mask = puncture.frame_mask(bitrate, level, "A")
    bits = rng.integers(0, 2, (4, fb), dtype=np.uint8)
    mother = channel.awgn_soft_symbols(channel.encode_batch(bits), rng, 5.0)
    rx = np.stack([puncture.puncture(m, mask) for m in mother]) \
        .astype(np.int32)
    got = np.asarray(dab.decode_punctured_frames(jnp.asarray(rx), bitrate,
                                                 level))
    want = golden.deconvolve_batch(
        fb, np.stack([puncture.depuncture(r, mask) for r in rx]))
    check(np.array_equal(got, want), "punctured decode differs from golden")
    # tail-biting
    fb = 192
    syms = np.stack([golden.hard_to_soft(golden.encode_tailbiting(
        rng.integers(0, 2, fb, dtype=np.uint8))) for _ in range(4)]) \
        .astype(np.int32)
    flips = rng.random(syms.shape) < 0.03
    syms[flips] = rng.integers(0, 256, int(flips.sum()))
    got = np.asarray(tailbiting.decode_tailbiting(jnp.asarray(syms), fb,
                                                  wrap_steps=96))
    want = np.stack([golden.tailbiting_decode(fb, s, wrap_steps=96)
                     for s in syms])
    check(np.array_equal(got, want), "tail-biting differs from golden")
    # StreamSession: 24 ms frames of a 32 kbit/s stream, pushed one by one
    frame, n_frames = 768, 6
    stream = frame * n_frames
    _, syms = channel.make_frames(2, stream, seed=seed)
    syms = syms.astype(np.int32)
    want = golden.deconvolve_batch(stream, syms)
    sess = StreamSession(2)
    outs = [sess.push(syms[:, i:i + 4 * frame])
            for i in range(0, 4 * stream, 4 * frame)]
    outs.append(sess.flush(syms[:, 4 * stream:]))
    check(np.array_equal(np.concatenate(outs, axis=1), want),
          "StreamSession differs from golden")
    dec = streaming.make_local_stream_decoder(stream, 3)
    got = np.asarray(dec(syms[:, :4 * stream], syms[:, 4 * stream:]))
    check(np.array_equal(got, want), "local stream decoder differs")
    return {"punctured": "EEP 3-A 64 kbit/s", "tailbiting_framebits": 192,
            "session_frames": n_frames, "local_blocks": 3}


def phase_four(n_superframes: int = 512, bitrate: int = 128,
               block_bits: int = 3072, batch: int = 64,
               seed: int = 7) -> dict:
    """--four: DP chain on a 4-device data mesh and SP streaming on a
    4-deep and a 2x2 ring, each against the one-device decode."""
    import jax

    from viterbi_tpu.harness import channel
    from viterbi_tpu.models import dab
    from viterbi_tpu.ops import decode
    from viterbi_tpu.parallel import mesh as mesh_mod, streaming
    from viterbi_tpu.runtime import dispatch

    devices = jax.devices()
    check(len(devices) >= 4, f"--four needs 4 devices, found {len(devices)}")
    rng = np.random.default_rng(seed)
    _, syms = _superframes(n_superframes, bitrate, rng)
    one = mesh_mod.make_mesh(n_data=1, n_seq=1, devices=devices[:1])
    four = mesh_mod.make_mesh(n_data=4, n_seq=1, devices=devices[:4])
    a1, e1 = dab.decode_ensemble_sharded(syms, bitrate, one)
    a4, e4 = dab.decode_ensemble_sharded(syms, bitrate, four)
    check(np.array_equal(np.asarray(a1), np.asarray(a4))
          and np.array_equal(np.asarray(e1), np.asarray(e4)),
          "4-device DAB+ chain differs from 1 device")
    stream_bits = 4 * block_bits
    _, syms = channel.make_frames(batch, stream_bits, seed=seed)
    syms = syms.astype(np.int32)
    whole = np.asarray(decode.decode(
        jax.device_put(syms, devices[0]), stream_bits, dispatch.variant()))
    res = {"dp_superframes": n_superframes}
    for n_data, n_seq in ((1, 4), (2, 2)):
        mesh = mesh_mod.make_mesh(n_data=n_data, n_seq=n_seq,
                                  devices=devices[:4])
        out = np.asarray(streaming.decode_stream(syms, stream_bits, mesh))
        check(np.array_equal(out, whole),
              f"SP {n_data}x{n_seq} differs from the one-device decode")
        res[f"sp_{n_data}x{n_seq}"] = f"{batch} x {stream_bits} bits"
    return res


def _use_fresh_config() -> None:
    """Start from the automatic variant: a config file left by earlier
    runs (e.g. a forced downgrade) must not change what is checked."""
    from viterbi_tpu.runtime import config
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "viterbi.txt")
    os.environ[config.CONFIG_ENV] = path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-device DP and SP paths")
    args = ap.parse_args(argv)

    import jax

    from viterbi_tpu.runtime import device

    device.require_gpu()
    import viterbi_tpu
    from viterbi_tpu.runtime import dispatch

    _use_fresh_config()
    viterbi_tpu.initialize()           # compile cache + variant choice
    devs = jax.devices()
    log(device.nvidia_smi())
    log(f"device_kind={devs[0].device_kind} count={len(devs)} "
        f"jax={jax.__version__} variant={dispatch.variant()}")
    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [("a api", phase_api), ("b ladder", phase_ladder),
                  ("c kernel_vs_xla", phase_kernel_vs_xla),
                  ("d rs", phase_rs), ("e chain", phase_chain),
                  ("f reach", phase_reach)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception as e:            # report every phase, then fail
            failed.append(name)
            log(f"phase {name}: FAIL ({time.perf_counter() - t0:.1f} s) "
                f"{e!r}")
            continue
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s) "
            f"{json.dumps(res)}")
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
