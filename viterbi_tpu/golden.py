"""Golden scalar models: the bit-exact oracle for every decode kernel.

Pure NumPy / Python implementations of

  * the K=7 rate-1/4 convolutional encoder (reference:
    viterbi-benchmark/viterbi-benchmark.cpp:303-311),
  * the soft-decision Viterbi decoder with the reference's exact
    numerics — rounding-average branch metrics, saturating u8 path
    metrics, renormalize-at-150 every two steps, terminated-trellis
    chainback from state 0 (deconvolve.cpp:232-435),
  * the RS(120,110) GF(256) decoder with Berlekamp-Massey / Chien /
    Forney and the reference's return-code contract
    (rschecksf.cpp:64-93, 198-377).

These run on the host and are deliberately simple; every JAX and CUDA
kernel in ``viterbi_tpu.ops`` is tested bit-exactly against them
(SURVEY.md §7.2 step 1).
"""

from __future__ import annotations

import numpy as np

from . import constants as C

# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(bits: np.ndarray) -> np.ndarray:
    """Encode data bits -> hard symbols in {0,1}.

    ``bits``: uint8[framebits] data bits. Returns uint8[4*(framebits+6)]:
    rate-1/4 symbols including the 6 zero flush (tail) bits, matching the
    symbol-stream layout ``deconvolve`` consumes (deconvolve.cpp:92).
    """
    bits = np.asarray(bits, dtype=np.uint8)
    padded = np.concatenate([bits, np.zeros(C.TAIL_BITS, dtype=np.uint8)])
    out = np.empty(C.RATE * len(padded), dtype=np.uint8)
    sr = 0
    for i, b in enumerate(padded):
        sr = ((sr << 1) | int(b)) & 0x7F
        for j, poly in enumerate(C.POLYS):
            out[C.RATE * i + j] = bin(sr & poly).count("1") & 1
    return out


def hard_to_soft(symbols: np.ndarray) -> np.ndarray:
    """Map hard symbols {0,1} to ideal soft values {0, 255} (offset-binary)."""
    return np.where(np.asarray(symbols) != 0, 255, 0).astype(np.uint32)


# ---------------------------------------------------------------------------
# Viterbi decoder (scalar, bit-exact)
# ---------------------------------------------------------------------------


def _avg_u8(a, b):
    """Rounding average, the ``pavgb`` semantics: (a + b + 1) >> 1."""
    return (a.astype(np.int32) + b.astype(np.int32) + 1) >> 1


def branch_metrics(syms4: np.ndarray) -> np.ndarray:
    """Per-butterfly branch metrics for one trellis step.

    ``syms4``: 4 soft symbols (ints; only the low byte is used, matching
    ``_mm_set1_epi8``/the SSE2 LUT clamp, deconvolve.cpp:141-165).
    Returns int32[32]: metric for the input-bit-0 branch from low
    predecessor ``b``; the other three branches of butterfly ``b`` use
    this metric or its complement 63 - metric (see constants.py).
    """
    pol = C.branch_polarity_table().astype(np.int32)       # [4, 32]
    s = (np.asarray(syms4, dtype=np.int64) & 0xFF).astype(np.int32)
    a = np.where(pol == 1, 255 - s[:, None], s[:, None])    # [4, 32]
    m = _avg_u8(_avg_u8(a[0], a[1]), _avg_u8(a[2], a[3]))
    return (m >> 2) & 63


def viterbi_forward(framebits: int, symbols: np.ndarray):
    """Forward ACS pass. Returns (decisions uint8[T,64], final_metrics).

    ``decisions[t, s]`` is 1 iff the survivor into *new* state ``s`` at
    step ``t`` came from the high predecessor (s>>1)+32. Tie-break: the
    high-predecessor path wins on equality, matching
    ``cmpeq(min(m1,m0), m1)`` (deconvolve.cpp:247-250).

    Renormalization fires after every second step when state 0's metric
    exceeds RENORMALIZE_THRESHOLD (deconvolve.cpp:398-405).
    """
    nsteps = framebits + C.TAIL_BITS
    symbols = np.asarray(symbols).reshape(-1)
    assert len(symbols) >= C.RATE * nsteps
    metrics = np.full(C.NUM_STATES, 63, dtype=np.int32)
    metrics[0] = 0
    decisions = np.zeros((nsteps, C.NUM_STATES), dtype=np.uint8)
    for t in range(nsteps):
        m = branch_metrics(symbols[C.RATE * t: C.RATE * (t + 1)])
        cm = 63 - m
        lo, hi = metrics[:32], metrics[32:]
        sat = lambda x: np.minimum(x, C.METRIC_MAX)
        p0e, p1e = sat(lo + m), sat(hi + cm)     # into even state 2b
        p0o, p1o = sat(lo + cm), sat(hi + m)     # into odd state 2b+1
        new = np.empty_like(metrics)
        new[0::2] = np.minimum(p0e, p1e)
        new[1::2] = np.minimum(p0o, p1o)
        decisions[t, 0::2] = (p1e <= p0e)
        decisions[t, 1::2] = (p1o <= p0o)
        metrics = new
        if t % 2 == 1 and metrics[0] > C.RENORMALIZE_THRESHOLD:
            metrics = np.maximum(metrics - C.RENORM_SUB, 0)
    return decisions, metrics


def chainback(framebits: int, decisions: np.ndarray) -> np.ndarray:
    """Traceback from state 0, returning MSB-first packed bytes.

    Implements the contract of ``ChainBack`` (deconvolve.cpp:416-435):
    start at state 0 (terminated trellis), read the decision bit for the
    current state at step t+6, predecessor = (state >> 1) | (bit << 5);
    the bit is the decoded data bit for position t.
    """
    out_bits = np.zeros(framebits, dtype=np.uint8)
    state = 0
    for t in range(framebits - 1, -1, -1):
        k = int(decisions[t + C.TAIL_BITS, state])
        out_bits[t] = k
        state = (state >> 1) | (k << 5)
    return np.packbits(out_bits)


def deconvolve(framebits: int, symbols: np.ndarray) -> np.ndarray:
    """Full golden decode: uint8[framebits//8] MSB-first packed bytes."""
    decisions, _ = viterbi_forward(framebits, symbols)
    return chainback(framebits, decisions)


def deconvolve_batch(framebits: int, symbols: np.ndarray) -> np.ndarray:
    """``deconvolve`` vectorized over frames, step for step the same
    numerics: [B, >=4*(framebits+6)] soft symbols -> uint8[B,
    ceil(framebits/8)]. Lets large samples be checked in seconds."""
    nsteps = framebits + C.TAIL_BITS
    syms = np.asarray(symbols)
    B = syms.shape[0]
    s = (syms[:, : C.RATE * nsteps].astype(np.int64) & 0xFF) \
        .astype(np.int32).reshape(B, nsteps, C.RATE)
    pol = C.branch_polarity_table().astype(bool)             # [4, 32]
    metrics = np.full((B, C.NUM_STATES), 63, dtype=np.int32)
    metrics[:, 0] = 0
    decisions = np.zeros((nsteps, B, C.NUM_STATES), dtype=np.uint8)
    sat = lambda x: np.minimum(x, C.METRIC_MAX)
    for t in range(nsteps):
        st = s[:, t, :, None]                                # [B, 4, 1]
        a = np.where(pol[None], 255 - st, st)                # [B, 4, 32]
        m = (_avg_u8(_avg_u8(a[:, 0], a[:, 1]),
                     _avg_u8(a[:, 2], a[:, 3])) >> 2) & 63   # [B, 32]
        cm = 63 - m
        lo, hi = metrics[:, :32], metrics[:, 32:]
        p0e, p1e = sat(lo + m), sat(hi + cm)
        p0o, p1o = sat(lo + cm), sat(hi + m)
        new = np.empty_like(metrics)
        new[:, 0::2] = np.minimum(p0e, p1e)
        new[:, 1::2] = np.minimum(p0o, p1o)
        decisions[t, :, 0::2] = p1e <= p0e
        decisions[t, :, 1::2] = p1o <= p0o
        metrics = new
        if t % 2 == 1:
            renorm = metrics[:, :1] > C.RENORMALIZE_THRESHOLD
            metrics = np.where(renorm,
                               np.maximum(metrics - C.RENORM_SUB, 0),
                               metrics)
    out_bits = np.zeros((B, framebits), dtype=np.uint8)
    state = np.zeros(B, dtype=np.int64)
    rows = np.arange(B)
    for t in range(framebits - 1, -1, -1):
        k = decisions[t + C.TAIL_BITS, rows, state].astype(np.int64)
        out_bits[:, t] = k
        state = (state >> 1) | (k << 5)
    return np.packbits(out_bits, axis=1)


# ---------------------------------------------------------------------------
# Tail-biting wrap decode (north-star item; no reference analog — the
# DAB mother code is terminated, SURVEY.md §2.1)
# ---------------------------------------------------------------------------


def encode_tailbiting(bits: np.ndarray) -> np.ndarray:
    """Tail-biting encode: the shift register is preloaded with the last
    6 data bits so start and end states coincide; no flush tail.
    Returns uint8[4*framebits] hard symbols."""
    bits = np.asarray(bits, dtype=np.uint8)
    sr = 0
    for b in bits[-C.TAIL_BITS:]:
        sr = ((sr << 1) | int(b)) & 0x7F
    out = np.empty(C.RATE * len(bits), dtype=np.uint8)
    for i, b in enumerate(bits):
        sr = ((sr << 1) | int(b)) & 0x7F
        for j, poly in enumerate(C.POLYS):
            out[C.RATE * i + j] = bin(sr & poly).count("1") & 1
    return out


def _acs_pass(metrics: np.ndarray, symbols: np.ndarray, t0: int,
              nsteps: int, decisions: np.ndarray | None):
    """Shared ACS loop body over steps t0..t0+nsteps-1 (wrap indexing
    into ``symbols``); renormalization fires on odd *local* step
    indices, preserving the reference's 2-step cadence."""
    total = symbols.size // C.RATE
    for local in range(nsteps):
        t = (t0 + local) % total
        m = branch_metrics(symbols[C.RATE * t: C.RATE * (t + 1)])
        cm = 63 - m
        lo, hi = metrics[:32], metrics[32:]
        sat = lambda x: np.minimum(x, C.METRIC_MAX)
        p0e, p1e = sat(lo + m), sat(hi + cm)
        p0o, p1o = sat(lo + cm), sat(hi + m)
        new = np.empty_like(metrics)
        new[0::2] = np.minimum(p0e, p1e)
        new[1::2] = np.minimum(p0o, p1o)
        if decisions is not None:
            decisions[local, 0::2] = (p1e <= p0e)
            decisions[local, 1::2] = (p1o <= p0o)
        metrics = new
        if local % 2 == 1 and metrics[0] > C.RENORMALIZE_THRESHOLD:
            metrics = np.maximum(metrics - C.RENORM_SUB, 0)
    return metrics


def tailbiting_decode(framebits: int, symbols: np.ndarray,
                      wrap_steps: int = 96) -> np.ndarray:
    """Tail-biting decode via the standard wrap heuristic.

    Procedure (the defined semantics every implementation must match
    bit-for-bit): (1) uniform zero initial metrics; (2) warm-up ACS over
    the last ``wrap_steps`` trellis steps — the decoder forgets its
    initial condition in ~5K steps, so the warm-up output approximates
    the circular steady state; (3) main ACS pass over all ``framebits``
    steps, recording decisions; (4) anchor at the best end state (lowest
    metric, lowest index on ties); (5) circular chainback: the decision
    at step t yields data bit (t - 6) mod framebits.

    Returns uint8[framebits//8] MSB-first packed bytes.
    """
    symbols = np.asarray(symbols).reshape(-1)
    assert symbols.size >= C.RATE * framebits
    assert wrap_steps % 2 == 0 and wrap_steps <= framebits
    symbols = symbols[: C.RATE * framebits]
    metrics = np.zeros(C.NUM_STATES, dtype=np.int32)
    metrics = _acs_pass(metrics, symbols, framebits - wrap_steps,
                        wrap_steps, None)
    decisions = np.zeros((framebits, C.NUM_STATES), dtype=np.uint8)
    metrics = _acs_pass(metrics, symbols, 0, framebits, decisions)
    state = int(np.argmin(metrics))
    out_bits = np.zeros(framebits, dtype=np.uint8)
    for t in range(framebits - 1, -1, -1):
        k = int(decisions[t, state])
        out_bits[(t - C.TAIL_BITS) % framebits] = k
        state = (state >> 1) | (k << 5)
    return np.packbits(out_bits)


# ---------------------------------------------------------------------------
# Reed-Solomon RS(120,110) decoder (scalar, bit-exact)
# ---------------------------------------------------------------------------

_ATO_MOD, _INDEX_OF = C.gf256_tables()
_A = int(C.RS_NN)  # 255, the "log of zero" sentinel


def _gf_mul_log(log_a: int, log_b: int) -> int:
    """alpha^(log_a + log_b) via the 768-entry pre-reduced antilog table."""
    return int(_ATO_MOD[log_a + log_b])


def rs_decode_codeword(data: np.ndarray) -> tuple[int, np.ndarray]:
    """Decode one shortened RS(120,110) codeword in place.

    ``data``: int array of 120 byte values (data[0..109] message,
    data[110..119] parity). Returns ``(count, corrected)`` where count is
    the number of corrected byte errors or -1 if uncorrectable — exactly
    DECODE_RS's contract (rschecksf.cpp:198-377).
    """
    data = np.asarray(data, dtype=np.int64).copy()
    n = C.RS_N
    nroots = C.RS_NROOTS
    pad = C.RS_PAD

    # Syndromes: s_i = sum_j data[j] * alpha^(i*(n-1-j)), Horner form.
    s = np.full(nroots, int(data[0]), dtype=np.int64)
    for j in range(1, n):
        for i in range(nroots):
            if s[i] == 0:
                s[i] = data[j]
            else:
                s[i] = data[j] ^ _gf_mul_log(int(_INDEX_OF[s[i]]), i)
    if not s.any():
        return 0, data  # valid codeword, nothing to do

    slog = [int(_INDEX_OF[v]) for v in s]  # syndromes in log form

    # Berlekamp-Massey: find the error locator polynomial lambda (log form
    # bookkeeping matches the reference so intermediate values agree).
    lam = [1] + [0] * nroots          # poly form
    b = [_A] * (nroots + 1)           # log form, b(x) = 1
    b[0] = 0
    el = 0
    for r in range(1, nroots + 1):
        discr = 0
        for i in range(r):
            if lam[i] != 0 and slog[r - 1 - i] != _A:
                discr ^= _gf_mul_log(int(_INDEX_OF[lam[i]]), slog[r - 1 - i])
        dlog = int(_INDEX_OF[discr])
        if dlog == _A:  # zero discrepancy: b(x) <- x*b(x)
            b = [_A] + b[:-1]
        else:
            t = [lam[0]] + [
                lam[i + 1] ^ (_gf_mul_log(dlog, b[i]) if b[i] != _A else 0)
                for i in range(nroots)
            ]
            if 2 * el <= r - 1:
                el = r - el
                b = [(_A if lam[i] == 0 else
                      int(C.mod255(int(_INDEX_OF[lam[i]]) - dlog + _A)))
                     for i in range(nroots + 1)]
            else:
                b = [_A] + b[:-1]
            lam = t

    lam_log = [int(_INDEX_OF[v]) for v in lam]
    deg_lambda = max((i for i in range(nroots + 1) if lam_log[i] != _A),
                     default=0)

    # Chien search over the whole field, aborting once all roots found.
    reg = list(lam_log)
    roots: list[int] = []
    for i in range(1, C.RS_NN + 1):
        q = 1
        for j in range(deg_lambda, 0, -1):
            if reg[j] != _A:
                reg[j] = int(C.mod255(reg[j] + j))
                q ^= int(_ATO_MOD[reg[j]])
        if q != 0:
            continue
        roots.append(i)
        if len(roots) == deg_lambda:
            break
    if len(roots) != deg_lambda:
        return -1, data  # uncorrectable

    # Error evaluator omega(x) = s(x) * lambda(x) mod x^nroots, log form.
    deg_omega = deg_lambda - 1
    omega_log = []
    for i in range(deg_omega + 1):
        tmp = 0
        for j in range(i, -1, -1):
            if slog[i - j] != _A and lam_log[j] != _A:
                tmp ^= _gf_mul_log(slog[i - j], lam_log[j])
        omega_log.append(int(_INDEX_OF[tmp]))

    # Forney: error magnitude at each root; positions inside the shortened
    # region (root > PAD) only — earlier roots fall in the implicit zeros.
    count = len(roots)
    for root in reversed(roots):
        if root < pad + 1:
            continue
        num1 = 0
        for i in range(deg_omega, -1, -1):
            if omega_log[i] != _A:
                num1 ^= int(_ATO_MOD[int(C.mod255(omega_log[i] + i * root))])
        if num1 == 0:
            continue
        num2 = int(_ATO_MOD[C.RS_NN - root])
        den = 0
        top = min(deg_lambda, nroots - 1) & ~1
        for i in range(top, -1, -2):
            if lam_log[i + 1] != _A:
                den ^= int(_ATO_MOD[int(C.mod255(lam_log[i + 1] + i * root))])
        tmp = (int(_INDEX_OF[num1]) + int(_INDEX_OF[num2])
               + (C.RS_NN - int(_INDEX_OF[den])))
        data[root - 1 - pad] ^= int(_ATO_MOD[tmp])

    return count, data


def rs_check_superframe(p: np.ndarray, rs_dims: int) -> tuple[int, np.ndarray]:
    """Check/correct a DAB+ superframe of ``rs_dims`` interleaved codewords.

    ``p``: uint8[rs_dims * 120] byte-interleaved input (codeword j's k-th
    byte at p[j + k*rs_dims]). Returns ``(errors, out)`` with ``out`` the
    uint8[rs_dims * 110] corrected data, errors = total corrected bytes or
    -1 on the first uncorrectable codeword — RScheckSuperframe's contract
    (rschecksf.cpp:64-93).
    """
    p = np.asarray(p, dtype=np.uint8).reshape(-1)
    out = np.zeros(rs_dims * C.RS_KK, dtype=np.uint8)
    errors = 0
    for j in range(rs_dims):
        block = p[j::rs_dims][:C.RS_N].astype(np.int64)
        count, corrected = rs_decode_codeword(block)
        if count == -1:
            return -1, out
        errors += count
        out[j::rs_dims] = corrected[:C.RS_KK].astype(np.uint8)
    return errors, out


def rs_encode_codeword(message: np.ndarray) -> np.ndarray:
    """Systematic RS(120,110) encoder (for tests; no reference analog —
    the benchmark never exercises the RS path, a gap SURVEY.md §4 flags).

    Appends 10 parity bytes so the 120-byte word evaluates to zero at
    alpha^0..alpha^9 in the *padded* RS(255,245) sense used by the
    decoder's Horner syndrome loop.
    """
    msg = np.asarray(message, dtype=np.int64).reshape(C.RS_KK)
    mul = C.gf256_mul_table().astype(np.int64)
    # Generator polynomial g(x) = prod_{i=0..9} (x - alpha^i); g[i] is the
    # coefficient of x^i, monic with deg 10.
    g = np.zeros(C.RS_NROOTS + 1, dtype=np.int64)
    g[0] = 1
    for i in range(C.RS_NROOTS):
        root = int(_ATO_MOD[i])
        shifted = np.concatenate([[0], g[:-1]])            # x * g(x)
        g = shifted ^ mul[g, root]                         # + alpha^i * g(x)
    # LFSR long division: rem holds x^9..x^0 coefficients, high-order first.
    rem = np.zeros(C.RS_NROOTS, dtype=np.int64)
    for m in msg:
        fb = int(rem[0]) ^ int(m)
        rem = np.concatenate([rem[1:], [0]])
        if fb:
            rem ^= mul[g[:C.RS_NROOTS][::-1], fb]
    return np.concatenate([msg, rem]).astype(np.uint8)
