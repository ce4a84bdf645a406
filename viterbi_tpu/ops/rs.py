"""Batched RS(120,110) decoder over GF(256), vectorized across codewords.

Batched reformulation of the reference's scalar DECODE_RS
(rschecksf.cpp:198-377): the serial loop over ``RSDims`` interleaved
codewords (rschecksf.cpp:74) becomes the batch axis, and every
data-dependent branch/early-exit of Berlekamp-Massey, Chien and Forney
becomes masked full-length execution (SURVEY.md §7.3) — results are
bit-identical to the scalar oracle.

GF(256) arithmetic is gather-free at runtime: instead of per-element
log/antilog table lookups (the reference's 768-entry pre-reduced
antilog scheme, dllmain.cpp:124-150), products use bitwise ``gf_mul``,
inverses the Fermat ``gf_inv`` (x^254), and alpha-powers
square-and-multiply over constant alpha^(2^k). Whether a table gather
is faster on the GPU is not measured yet. The tables survive only as
host-side data for building the bit-matmul matrices (syndromes/Chien).
GF arithmetic is exact, so every result is bit-identical to the
reference's log-form computation.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C

_ATO_NP, _IOF_NP = C.gf256_tables()
_A = 255  # "log of zero" sentinel (c_nn)

# alpha-power exponents for the syndrome evaluation: codeword byte j is the
# coefficient of x^(119-j); syndrome i evaluates at alpha^i, so byte j
# contributes data[j] * alpha^(i*(119-j)).
_SYN_EXP = np.array(
    [[(i * (C.RS_N - 1 - j)) % 255 for i in range(C.RS_NROOTS)]
     for j in range(C.RS_N)], dtype=np.int32)


def _bit_matrices():
    """GF(2) bit-sliced evaluation matrices for the matrix unit.

    Syndrome and Chien evaluations are GF(2)-LINEAR in the input bits:
    s_i = XOR_j data[j] * alpha^(i*(119-j)) and q(i) = XOR_j
    lam[j] * alpha^(i*j). Expanding bytes into bits turns each into an
    exact integer matmul (bit-parity = accumulated count mod 2).

    Returns (SYND [960, 80], CHIEN [88, 2040]) uint8 0/1 matrices:
      SYND[(j,a), (i,b)]   = bit b of alpha^((a + i*(119-j)) % 255)
      CHIEN[(j,a), (i-1,b)] = bit b of alpha^((a + i*j) % 255), i=1..255
    """
    a = np.arange(8)
    # syndromes
    j_s = np.arange(C.RS_N)
    e_s = (a[None, :, None] + np.arange(C.RS_NROOTS)[None, None, :]
           * (C.RS_N - 1 - j_s)[:, None, None]) % 255     # [120, 8, 10]
    v_s = _ATO_NP[e_s].astype(np.int64)                    # value bytes
    synd = ((v_s[..., None] >> a) & 1).astype(np.uint8)    # [120,8,10,8]
    synd = synd.reshape(C.RS_N * 8, C.RS_NROOTS * 8)
    # chien (evaluation at alpha^i for i = 1..255)
    j_c = np.arange(C.RS_NROOTS + 1)
    e_c = (a[None, :, None] + np.arange(1, C.RS_NN + 1)[None, None, :]
           * j_c[:, None, None]) % 255                     # [11, 8, 255]
    v_c = _ATO_NP[e_c].astype(np.int64)
    chien = ((v_c[..., None] >> a) & 1).astype(np.uint8)   # [11,8,255,8]
    chien = chien.reshape((C.RS_NROOTS + 1) * 8, C.RS_NN * 8)
    return synd, chien


_SYND_M, _CHIEN_M = _bit_matrices()


def _byte_bits(x: jax.Array) -> jax.Array:
    """[..., n] bytes -> [..., n*8] bits (LSB first)."""
    b = (x[..., None] >> jnp.arange(8, dtype=x.dtype)) & 1
    return b.reshape(*x.shape[:-1], x.shape[-1] * 8)


def _gf2_matmul(bits: jax.Array, m: np.ndarray) -> jax.Array:
    """Exact parity matmul: [B, K] 0/1 @ [K, N] 0/1 -> [B, N] int32 0/1.

    bf16 inputs represent 0/1 exactly; f32 accumulation is exact for
    counts <= 2^24 (here K <= 960), and parity = count & 1. The
    precision is pinned so no backend may pick a reduced-precision
    product.
    """
    acc = jnp.dot(bits.astype(jnp.bfloat16),
                  jnp.asarray(m, dtype=jnp.bfloat16),
                  precision=jax.lax.Precision.HIGHEST,
                  preferred_element_type=jnp.float32)
    return acc.astype(jnp.int32) & 1


def _tables():
    return jnp.asarray(_ATO_NP.astype(np.int32)), \
        jnp.asarray(_IOF_NP.astype(np.int32))


def _mod255(x: jax.Array) -> jax.Array:
    """Branch-free x % 255 with the reference's uint32-wrap semantics."""
    prod = x.astype(jnp.uint32) * jnp.uint32(0x1010102)
    return (prod >> 24).astype(jnp.int32)


def gf_mul(a: jax.Array, b: jax.Array) -> jax.Array:
    """Exact GF(256) product of int32 arrays (values < 256), gather-free.

    Carryless polynomial multiply (8 conditional-XOR rounds) followed by
    reduction mod the field polynomial 0x11D: ~45 elementwise ops and
    no table gather.
    """
    acc = jnp.zeros_like(a)
    for k in range(8):
        acc = acc ^ jnp.where((b >> k) & 1 != 0, a << k, 0)
    for k in range(14, 7, -1):
        acc = acc ^ jnp.where((acc >> k) & 1 != 0,
                              jnp.int32(C.RS_GFPOLY << (k - 8)), 0)
    return acc


def _gf_mul_const(a: jax.Array, b: int) -> jax.Array:
    """gf_mul with a compile-time scalar: the conditional-XOR rounds fold
    to popcount(b) shift-xors."""
    acc = jnp.zeros_like(a)
    for k in range(8):
        if (b >> k) & 1:
            acc = acc ^ (a << k)
    for k in range(14, 7, -1):
        acc = acc ^ jnp.where((acc >> k) & 1 != 0,
                              jnp.int32(C.RS_GFPOLY << (k - 8)), 0)
    return acc


def gf_inv(x: jax.Array) -> jax.Array:
    """Fermat inverse x^254 (gf_inv(0) == 0), 13 gf_muls, gather-free."""
    sq = gf_mul(x, x)                     # x^2
    acc = sq
    p = sq
    for _ in range(6):
        p = gf_mul(p, p)                  # x^4 .. x^128
        acc = gf_mul(acc, p)
    return acc


# alpha^(2^k) scalar constants for square-and-multiply exponentiation
_A2K = [int(_ATO_NP[(1 << k) % 255]) for k in range(8)]


def gf_pow_alpha(e: jax.Array) -> jax.Array:
    """alpha^e for integer exponents e in [0, 255], gather-free
    square-and-multiply over the constant powers alpha^(2^k)."""
    acc = jnp.ones_like(e)
    for k in range(8):
        acc = jnp.where((e >> k) & 1 != 0, _gf_mul_const(acc, _A2K[k]),
                        acc)
    return acc


def _xor_reduce(x: jax.Array, axis: int) -> jax.Array:
    return jax.lax.reduce(x, np.int32(0), jax.lax.bitwise_xor, (axis,))


@jax.jit
def rs_decode_blocks(blocks: jax.Array):
    """Decode a batch of shortened RS(120,110) codewords.

    ``blocks``: uint8/int32 [B, 120]. Returns ``(count, corrected)``:
      * count int32[B]: corrected byte errors per codeword, or -1
      * corrected int32[B, 120]: corrected codewords (unchanged where
        count == -1 or 0), values in [0, 255].
    Bit-exact vs golden.rs_decode_codeword for every codeword.
    """
    data = blocks.astype(jnp.int32)
    B = data.shape[0]
    NR = C.RS_NROOTS

    # ---- Syndromes (bit-matmul) ------------------------------------------
    sbits = _gf2_matmul(_byte_bits(data), _SYND_M)           # [B, 80]
    s = jnp.sum(sbits.reshape(B, C.RS_NROOTS, 8)
                << jnp.arange(8, dtype=jnp.int32), axis=-1)  # [B, 10]
    syn_zero = jnp.all(s == 0, axis=1)                       # [B]

    # ---- Berlekamp-Massey (10 masked rounds, poly form) ------------------
    # Both lambda and b kept in polynomial form; GF products via the
    # gather-free bitwise gf_mul (the reference's log-form bookkeeping is
    # an x86 LUT optimization, results are identical).
    lam = jnp.zeros((B, NR + 1), jnp.int32).at[:, 0].set(1)  # poly form
    b = jnp.zeros((B, NR + 1), jnp.int32).at[:, 0].set(1)    # poly form
    el = jnp.zeros((B,), jnp.int32)
    idx = jnp.arange(NR + 1, dtype=jnp.int32)

    for r in range(1, NR + 1):  # static unroll, masks handle divergence
        # discrepancy: XOR over i < r of lam[i] * s[r-1-i]
        s_take = s[:, (r - 1 - np.arange(NR + 1)) % NR]      # [B, 11]
        valid = (np.arange(NR + 1) < r)[None, :]
        discr = _xor_reduce(
            jnp.where(valid, gf_mul(lam, s_take), 0), axis=1)  # [B]
        zero_d = discr == 0

        shift_b = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), b[:, :-1]], axis=1)

        # t(x) = lambda(x) - discr * x * b(x)
        t = lam ^ gf_mul(discr[:, None], shift_b)

        upd = (2 * el <= r - 1) & ~zero_d                    # register swap
        # b(x) <- lambda(x) / discr (Fermat inverse, gather-free)
        inv_d = gf_inv(discr)                                # [B]
        b_swap = gf_mul(lam, inv_d[:, None])
        new_b = jnp.where(zero_d[:, None], shift_b,
                          jnp.where(upd[:, None], b_swap, shift_b))
        new_lam = jnp.where(zero_d[:, None], lam, t)
        el = jnp.where(upd, r - el, el)
        lam, b = new_lam, new_b

    deg_lambda = jnp.max(jnp.where(lam != 0, idx[None, :], 0), axis=1)

    # ---- Chien search (bit-matmul over all 255 field elements) -----------
    # q(i) = XOR_{j=0..10} lam[j] * alpha^(i*j); zero coefficients
    # contribute nothing, so masking by deg_lambda is unnecessary, and
    # counting all roots equals the reference's abort-at-deg search (a
    # degree-d polynomial has at most d roots).
    i_all = jnp.arange(1, C.RS_NN + 1, dtype=jnp.int32)      # [255]
    qbits = _gf2_matmul(_byte_bits(lam), _CHIEN_M)           # [B, 2040]
    is_root = jnp.sum(qbits.reshape(B, C.RS_NN, 8), axis=-1) == 0
    count = jnp.sum(is_root, axis=1).astype(jnp.int32)
    correctable = count == deg_lambda

    # first <=10 roots in ascending order, as in the reference's abort-at-
    # deg_lambda search (a degree-d poly has at most d<=10 roots, so taking
    # the 10 smallest is equivalent).
    root_keys = jnp.where(is_root, i_all[None, :], jnp.int32(999))
    roots = jax.lax.top_k(-root_keys, NR)[0] * -1            # [B, 10] asc
    root_ok = roots < 999

    # ---- Omega = s(x) * lambda(x) mod x^10 (poly form, gather-free) -------
    ii = np.arange(NR)[:, None]          # omega coefficient index i
    jj = np.arange(NR + 1)[None, :]      # lambda index j
    pair_ok = (jj <= ii)
    s_idx = np.where(pair_ok, ii - jj, 0)
    oterm = gf_mul(s[:, s_idx], lam[:, None, :])             # [B, 10, 11]
    omega = _xor_reduce(jnp.where(pair_ok[None], oterm, 0), axis=2)

    # ---- Forney error values at each root --------------------------------
    # powers pw[b, slot, k] = alpha^(k * root) built by iterated gf_mul
    safe_root = jnp.where(root_ok, roots, 0)
    alpha_r = gf_pow_alpha(safe_root)                        # [B, 10]
    pw_list = [jnp.ones_like(alpha_r)]
    for _ in range(NR - 1):
        pw_list.append(gf_mul(pw_list[-1], alpha_r))
    pw = jnp.stack(pw_list, axis=2)                          # [B, 10, 10]

    deg_omega = deg_lambda - 1
    k = np.arange(NR, dtype=np.int32)                        # [10]
    n1_term = gf_mul(omega[:, None, :], pw)                  # [B, 10, 10]
    n1_valid = k[None, None, :] <= deg_omega[:, None, None]
    num1 = _xor_reduce(jnp.where(n1_valid, n1_term, 0), axis=2)  # [B, 10r]

    num2 = gf_pow_alpha(C.RS_NN - safe_root)                 # [B, 10]

    keven = np.arange(0, NR, 2, dtype=np.int32)              # [5]
    top = jnp.minimum(deg_lambda, NR - 1) & ~1               # [B]
    d_term = gf_mul(lam[:, None, keven + 1], pw[:, :, keven])
    d_valid = keven[None, None, :] <= top[:, None, None]
    den = _xor_reduce(jnp.where(d_valid, d_term, 0), axis=2)  # [B, 10]

    # errval = num1 * num2 / den in GF(256); den != 0 wherever applied
    # (simple roots), num1 == 0 is masked below — identical to the
    # reference's log-form ato[iof[num1]+iof[num2]+255-iof[den]]
    errval = gf_mul(gf_mul(num1, num2), gf_inv(den))         # [B, 10]

    pos = roots - 1 - C.RS_PAD                               # [B, 10]
    apply = root_ok & (roots >= C.RS_PAD + 1) & (num1 != 0) & \
        correctable[:, None] & ~syn_zero[:, None]
    onehot = (pos[:, :, None] ==
              jnp.arange(C.RS_N, dtype=jnp.int32)[None, None, :])
    corr = jnp.sum(jnp.where(apply[:, :, None] & onehot, errval[:, :, None],
                             0), axis=1)                     # [B, 120]
    corrected = data ^ corr

    count = jnp.where(syn_zero, 0, jnp.where(correctable, count, -1))
    corrected = jnp.where((count[:, None] >= 0), corrected, data)
    return count, corrected


def deinterleave(p: jax.Array, rs_dims: int) -> jax.Array:
    """[rs_dims*120] byte-interleaved superframe -> [rs_dims, 120] blocks."""
    return p.reshape(C.RS_N, rs_dims).T


def interleave_data(blocks: jax.Array, rs_dims: int) -> jax.Array:
    """[rs_dims, 110] corrected data -> [rs_dims*110] interleaved output."""
    return blocks.T.reshape(rs_dims * C.RS_KK)


@partial(jax.jit, static_argnames=("rs_dims",))
def rs_check_superframe(p: jax.Array, rs_dims: int):
    """Batched twin of RScheckSuperframe (rschecksf.cpp:64-93).

    ``p``: uint8[rs_dims * 120]. Returns (errors, out, n_ok):
      * errors int32: total corrected bytes, or -1 if any codeword is
        uncorrectable (reference aborts at the *first* such codeword)
      * out uint8[rs_dims * 110]: corrected data. On -1 the reference
        scatters each corrected codeword *before* the failed one into
        the caller's buffer (rschecksf.cpp:74-88), so the prefix
        survives; here codewords from the first failure onward are
        zero-filled in ``out`` and ``n_ok`` tells the caller how many
        leading codewords are valid (= rs_dims when errors != -1).
    """
    blocks = deinterleave(p.astype(jnp.int32), rs_dims)
    count, corrected = rs_decode_blocks(blocks)
    failed = count < 0
    any_failed = jnp.any(failed)
    first_fail = jnp.argmax(failed)  # 0 if none, but gated by any_failed
    errors = jnp.where(any_failed, -1, jnp.sum(count))
    n_ok = jnp.where(any_failed, first_fail, rs_dims).astype(jnp.int32)
    # zero out output for codewords at/after the first failure
    cw_idx = jnp.arange(rs_dims, dtype=jnp.int32)
    out_blocks = jnp.where((cw_idx < n_ok)[:, None],
                           corrected[:, :C.RS_KK], 0)
    out = interleave_data(out_blocks, rs_dims).astype(jnp.uint8)
    return errors.astype(jnp.int32), out, n_ok
