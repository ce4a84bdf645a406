"""Benchmark: batched DAB decode throughput on one GPU.

Prints JSON lines; the LAST complete line on stdout is the most complete
result:
  {"metric": "viterbi_decode_throughput", "value": N,
   "unit": "Msymbols/s/chip", "vs_baseline": R, "device": {...}, ...}

The headline Viterbi metric is printed as soon as it is measured, then
re-printed with the bitrate ladder and the RS / superframe rates folded
in. Every line carries the device (JAX platform, device kind and count,
and the card's name and power limit from nvidia-smi). A failed phase
exits non-zero after printing what was measured before it. Only a GPU
is measured: on any other backend the script exits non-zero.

Methodology mirrors the reference benchmark (viterbi-benchmark.cpp:
332-348): warm-up calls, then timed steady-state calls at the 128 kbit/s
operating point (framebits 3072), counting consumed soft symbols
(4*(framebits+6) per frame). Symbols are device-resident and every
timed window ends in ``block_until_ready``.

``vs_baseline`` is the ratio to the reference AVX-512 decoder's
**measured** symbols/s — CALIBRATION.json, produced by
scripts/calibrate_x86.py on an x86 host (BASELINE.md "Calibrated
baseline"). ``vs_estimate_2e9`` keeps the round-1 desktop-class
instruction-count estimate (SURVEY.md §6) visible alongside.

``extra`` rates (BASELINE.json config 3): standalone RS(120,110) decode
in codewords/s and the chained deconvolve->RS DAB+ audio superframe
pipeline in superframes/s.

Env knobs: BENCH_BATCH (default 16384), BENCH_FRAMEBITS (3072),
BENCH_ITERS (100), BENCH_VARIANT (a dispatch.VARIANTS name; default:
the dispatcher's choice), BENCH_SKIP_EXTRA=1 to bench only the Viterbi
path. The compile cache is JAX_COMPILATION_CACHE_DIR when set, else
<repo>/.jax_cache.
"""

import json
import os
import sys
import time

import numpy as np

# Round-1 instruction-count estimate for a desktop-class AVX-512 part
# (SURVEY.md §6); superseded as the primary denominator by the measured
# CALIBRATION.json rate but still reported.
ESTIMATE_SYMBOLS_PER_S = 2.0e9


def _load_calibration():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "CALIBRATION.json")
    with open(path) as f:
        cal = json.load(f)
    k = cal["kernels"]
    return (float(k["avx512"]["symbols_per_s"]),
            float(k.get("rs", {}).get("codewords_per_s", 0)) or None)


def _timeit(fn, args, iters, warmup):
    fn(*args).block_until_ready()
    for _ in range(warmup):
        out = fn(*args)
    out.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    out.block_until_ready()
    return (time.perf_counter() - t0) / iters


def main():
    import jax
    import jax.numpy as jnp

    import viterbi_tpu
    from viterbi_tpu import constants as C
    from viterbi_tpu.ops import decode as decode_ops
    from viterbi_tpu.runtime import device, dispatch

    device.require_gpu()
    viterbi_tpu.initialize()           # compile cache + variant choice
    framebits = int(os.environ.get("BENCH_FRAMEBITS", 3072))
    batch = int(os.environ.get("BENCH_BATCH", 16384))
    iters = int(os.environ.get("BENCH_ITERS", 100))
    variant = os.environ.get("BENCH_VARIANT") or dispatch.variant()

    nsteps = framebits + C.TAIL_BITS
    rng = np.random.default_rng(0)
    syms = jnp.asarray(rng.integers(0, 256, (batch, C.RATE * nsteps),
                                    dtype=np.int32))
    fn = jax.jit(lambda s: decode_ops.decode(s, framebits, variant))
    dt = _timeit(fn, (syms,), iters, max(10, iters // 4))
    rate = batch * C.RATE * nsteps / dt

    measured, rs_baseline = _load_calibration()
    result = {
        "metric": "viterbi_decode_throughput",
        "value": round(rate / 1e6, 2),
        "unit": "Msymbols/s/chip",
        "vs_baseline": round(rate / measured, 3),
        "vs_estimate_2e9": round(rate / ESTIMATE_SYMBOLS_PER_S, 3),
        "baseline_symbols_per_s": measured,
        "baseline_source": "CALIBRATION.json measured avx512",
        "variant": variant,
        "device": device.describe(),
    }
    # Emit the headline metric immediately: if a later phase fails, the
    # last complete JSON line on stdout is still a valid result.
    print(json.dumps(result), flush=True)
    if os.environ.get("BENCH_SKIP_EXTRA") == "1":
        return 0

    try:
        # bitrate ladder at a production batch: each rate's own
        # per-call cost travels with the best-shape headline
        lad_B = int(os.environ.get("BENCH_LADDER_BATCH", 8192))
        lad_iters = max(5, iters // 10)
        min_rate = None
        for kbps in (32, 64, 96, 128, 192, 384):
            fb = 24 * kbps
            ns = fb + C.TAIL_BITS
            lsyms = jnp.asarray(rng.integers(0, 256, (lad_B, C.RATE * ns),
                                             dtype=np.int32))
            lfn = jax.jit(lambda s, fb=fb: decode_ops.decode(s, fb, variant))
            lrate = lad_B * C.RATE * ns / _timeit(lfn, (lsyms,), lad_iters, 2)
            min_rate = lrate if min_rate is None else min(min_rate, lrate)
        result["min_ladder_gsym_s"] = round(min_rate / 1e9, 3)
        result["ladder_ratio"] = round(rate / min_rate, 3)
        result["ladder_batch"] = lad_B
        print(json.dumps(result), flush=True)

        from viterbi_tpu import golden
        from viterbi_tpu.models import dab
        from viterbi_tpu.ops import rs as rs_ops
        from viterbi_tpu.parallel import mesh as mesh_mod

        # standalone RS(120,110): realistic mix — mostly clean codewords
        # (the early-out common case, rschecksf.cpp:222-230) + some with
        # correctable errors
        n_cw = int(os.environ.get("BENCH_RS_CODEWORDS", 65536))
        msgs = rng.integers(0, 256, (256, C.RS_KK), dtype=np.int32)
        clean = np.stack([golden.rs_encode_codeword(m) for m in msgs])
        clean = np.tile(clean, (n_cw // 256, 1)).astype(np.int32)

        def corrupt_mix(base, frac, max_errs, uncorrectable=0):
            """frac of codewords get 1..max_errs byte errors; the first
            `uncorrectable` codewords get 9 errors (> t=5, forces the
            -1 path)."""
            cws = base.copy()
            n = len(cws)
            # unique positions per row via argsort of random keys
            pos = rng.random((n, C.RS_N)).argsort(axis=1)[:, :9]
            vals = rng.integers(1, 256, (n, 9))
            nerr = rng.integers(1, max_errs + 1, n)
            nerr = np.where(rng.random(n) < frac, nerr, 0)
            if uncorrectable:
                nerr[:uncorrectable] = 9
            use = np.arange(9)[None, :] < nerr[:, None]
            flat = (np.arange(n)[:, None] * C.RS_N + pos)[use]
            np.bitwise_xor.at(cws.reshape(-1), flat, vals[use])
            return jnp.asarray(cws, jnp.int32)

        rs_fn = jax.jit(lambda b: rs_ops.rs_decode_blocks(b)[0])
        rs_iters = max(5, iters // 4)
        rs_dt = _timeit(rs_fn, (corrupt_mix(clean, 0.25, 1),), rs_iters, 5)
        result["rs_codewords_per_s"] = round(n_cw / rs_dt, 1)
        if rs_baseline:
            result["rs_vs_baseline"] = round(n_cw / rs_dt / rs_baseline, 3)
        # adversarial batches: Forney-heavy (every codeword dirty, up
        # to t=5 errors) and a batch containing uncorrectable words
        rs_dt_dirty = _timeit(rs_fn, (corrupt_mix(clean, 1.0, 5),),
                              rs_iters, 5)
        result["rs_codewords_per_s_dirty"] = round(n_cw / rs_dt_dirty, 1)
        rs_dt_abort = _timeit(
            rs_fn, (corrupt_mix(clean, 0.25, 5, uncorrectable=64),),
            rs_iters, 5)
        result["rs_codewords_per_s_with_uncorrectable"] = round(
            n_cw / rs_dt_abort, 1)

        # chained deconvolve -> RS superframe pipeline (config 3),
        # through the sharded ensemble entry point on a 1-device mesh
        n_sf = int(os.environ.get("BENCH_SUPERFRAMES", 512))
        sf_syms = jnp.asarray(rng.integers(
            0, 256, (n_sf, 5, C.RATE * nsteps), dtype=np.int32))
        sf_mesh = mesh_mod.make_mesh(n_data=1, n_seq=1)
        sf_fn = jax.jit(lambda s: dab.decode_ensemble_sharded(
            s, framebits // 24, sf_mesh, variant=variant)[1])
        sf_dt = _timeit(sf_fn, (sf_syms,), max(5, iters // 8), 3)
        result["superframes_per_s"] = round(n_sf / sf_dt, 1)
    except Exception as e:
        print(f"bench phase failed: {e!r}", file=sys.stderr)
        print(json.dumps(result), flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
