"""DAB / DAB+ decode chains — the "model" layer.

The reference exposes two hot primitives (deconvolve +
RScheckSuperframe) and leaves their composition to QIRX. Here the
composition is a first-class, jittable pipeline so a whole DAB+ audio
superframe batch decodes on-device end to end (BASELINE.json config 3):

    subchannel soft symbols (5 logical frames, 24 ms each)
      -> batched Viterbi deconvolve        (ops.decode, dispatched)
      -> pack to bytes, assemble superframe
      -> RS(120,110) check/correct         (ops.rs)
      -> corrected audio superframe bytes + error counts

Shapes follow DAB terminology: a subchannel at ``bitrate`` kbit/s
yields framebits = 24 * bitrate per 24 ms logical frame
(viterbi-benchmark.cpp:56); a DAB+ audio superframe spans 5 logical
frames whose decoded bytes form ``rs_dims = superframe_bytes / 120``
interleaved RS codewords (rschecksf.cpp:58-62).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache, partial

import jax
import jax.numpy as jnp

from .. import constants as C
from ..ops import decode as decode_ops, rs as rs_ops
from ..runtime import dispatch

SUPERFRAME_FRAMES = 5  # logical frames per DAB+ audio superframe


@dataclasses.dataclass(frozen=True)
class SubchannelConfig:
    """A DAB subchannel's decode geometry."""
    bitrate_kbps: int                      # 8..384 (old DAB max)

    @property
    def framebits(self) -> int:
        return 24 * self.bitrate_kbps

    @property
    def frame_bytes(self) -> int:
        return self.framebits // 8

    @property
    def superframe_bytes(self) -> int:
        return SUPERFRAME_FRAMES * self.frame_bytes

    @property
    def rs_dims(self) -> int:
        """Interleaved RS codewords per superframe (120 B each)."""
        assert self.superframe_bytes % C.RS_N == 0, (
            "bitrate incompatible with DAB+ superframe RS layout")
        return self.superframe_bytes // C.RS_N

    @property
    def symbols_per_frame(self) -> int:
        return C.RATE * (self.framebits + C.TAIL_BITS)


def bytes_to_superframes(frame_bytes: jax.Array, cfg: SubchannelConfig):
    """[B, 5, frame_bytes] decoded frame bytes -> [B, superframe_bytes]."""
    B = frame_bytes.shape[0]
    return frame_bytes.reshape(B, cfg.superframe_bytes)


@partial(jax.jit, static_argnames=("bitrate_kbps", "variant"))
def decode_audio_superframes(symbols: jax.Array, bitrate_kbps: int,
                             variant: str = "jax_blocked"):
    """Decode a batch of DAB+ audio superframes end to end on device.

    ``symbols``: int32[B, 5, 4*(framebits+6)] soft symbols for 5
    consecutive logical frames of one subchannel (already depunctured,
    as the reference expects — SURVEY.md §2.1).

    Returns (audio uint8[B, rs_dims*110], rs_errors int32[B]):
    corrected audio superframe bytes and per-superframe corrected-byte
    counts (-1 = uncorrectable, matching RScheckSuperframe).
    ``variant`` names the Viterbi kernel (``runtime.dispatch.VARIANTS``).
    """
    cfg = SubchannelConfig(bitrate_kbps)
    B = symbols.shape[0]
    flat = symbols.reshape(B * SUPERFRAME_FRAMES, -1).astype(jnp.int32)

    frame_bytes = decode_ops.decode(flat, cfg.framebits, variant)

    sf = bytes_to_superframes(
        frame_bytes.reshape(B, SUPERFRAME_FRAMES, cfg.frame_bytes), cfg)

    # deinterleave each superframe into its RS codewords and decode the
    # whole [B * rs_dims, 120] block batch at once
    blocks = sf.reshape(B, C.RS_N, cfg.rs_dims).transpose(0, 2, 1)
    count, corrected = rs_ops.rs_decode_blocks(
        blocks.reshape(B * cfg.rs_dims, C.RS_N).astype(jnp.int32))
    count = count.reshape(B, cfg.rs_dims)
    corrected = corrected.reshape(B, cfg.rs_dims, C.RS_N)

    any_fail = jnp.any(count < 0, axis=1)
    errors = jnp.where(any_fail, -1, count.sum(axis=1)).astype(jnp.int32)
    audio = corrected[:, :, :C.RS_KK].transpose(0, 2, 1).reshape(
        B, cfg.rs_dims * C.RS_KK).astype(jnp.uint8)
    return audio, errors


def decode_ensemble_sharded(symbols, bitrate_kbps: int, mesh=None,
                            variant: str | None = None):
    """The full DAB+ audio chain as ONE jitted SHARDED call: a batch of
    subchannel superframes -> Viterbi -> superframe assembly -> RS ->
    audio bytes + error counts, data-parallel over the mesh's data axis
    (the QIRX composition the DLL serves, rschecksf.cpp:58-93, scaled
    across devices instead of host threads).

    ``symbols``: int[B, 5, 4*(framebits+6)], B divisible by the data-
    axis size. Returns (audio uint8[B, rs_dims*110], errors int32[B]).
    ``variant=None`` takes the dispatcher's selected variant.
    Composes with SP streaming: a subchannel whose frames arrive as one
    long stream can decode via parallel.streaming first, then feed the
    RS stage here.
    """
    from ..parallel import mesh as mesh_mod

    if mesh is None:
        mesh = mesh_mod.make_mesh(n_data=len(jax.devices()), n_seq=1)
    if variant is None:
        variant = dispatch.variant()
    return _ensemble_decoder(bitrate_kbps, mesh, variant)(
        jnp.asarray(symbols, dtype=jnp.int32))


@lru_cache(maxsize=32)
def _ensemble_decoder(bitrate_kbps: int, mesh, variant: str):
    """Cached jitted sharded chain (a fresh closure per call would
    recompile every invocation; Mesh is hashable)."""
    import jax as _jax
    from jax.sharding import PartitionSpec as P

    from ..parallel import mesh as mesh_mod

    def body(s):
        return decode_audio_superframes(s, bitrate_kbps, variant=variant)

    sharded = _jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(mesh_mod.DATA_AXIS, None, None),),
        out_specs=(P(mesh_mod.DATA_AXIS, None),
                   P(mesh_mod.DATA_AXIS)),
        check_vma=False)
    return _jax.jit(sharded)


def depuncture_device(received: jax.Array, mask) -> jax.Array:
    """Jittable depuncture: [B, n_kept] soft symbols -> [B, 4*(I+6)].

    ``mask`` is a host-side uint8 transmission mask
    (models.puncture.frame_mask); punctured positions become the neutral
    soft value. The scatter compiles to one static-index set.
    """
    import numpy as np
    from . import puncture as P
    mask = np.asarray(mask, dtype=bool)
    idx = jnp.asarray(np.nonzero(mask)[0])
    B = received.shape[0]
    out = jnp.full((B, mask.size), P.NEUTRAL_SOFT, dtype=jnp.int32)
    return out.at[:, idx].set(received.astype(jnp.int32))


@lru_cache(maxsize=64)
def _masked_decoder(segments: tuple, variant: str):
    """Jitted depuncture+decode closure for one profile.

    Cached on the profile's small ``segments`` tuple — the alternative
    (a jit static arg holding the ~4*I-element mask tuple) would hash
    tens of thousands of Python ints on every call, milliseconds of
    overhead on a per-frame path.
    """
    from . import puncture as P
    prof = P.Profile("cached", segments)
    mask = prof.mask()
    framebits = prof.data_bits

    @jax.jit
    def decode(received):
        full = depuncture_device(received, mask)
        return decode_ops.decode(full, framebits, variant)

    return decode


def decode_punctured_frames(received: jax.Array, bitrate_kbps: int,
                            level: int, profile: str = "A",
                            variant: str | None = None) -> jax.Array:
    """Decode punctured logical frames of an EEP-protected subchannel.

    ``received``: int32[B, transmitted_bits] punctured soft symbols (the
    over-the-air layout). Depunctures to the rate-1/4 mother stream and
    runs the batched Viterbi decode (``variant=None``: the dispatcher's
    selected variant). Returns uint8[B, framebits//8].
    """
    from . import puncture as P
    prof = P.eep_profile(bitrate_kbps, level, profile)
    return _masked_decoder(prof.segments,
                           variant or dispatch.variant())(received)


def decode_profile_frames(received: jax.Array, profile,
                          variant: str | None = None) -> jax.Array:
    """Decode punctured frames of ANY ``puncture.Profile`` — including
    user-transcribed UEP rows (``puncture.uep_profile_from_row``).

    ``received``: int32[B, profile.transmitted_bits] soft symbols.
    Returns uint8[B, profile.data_bits // 8]. Each distinct profile
    compiles once (cached on its segment tuple).
    """
    return _masked_decoder(profile.segments,
                           variant or dispatch.variant())(received)
