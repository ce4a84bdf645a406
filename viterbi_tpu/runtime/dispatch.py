"""Variant dispatch + capability probe — the L3 analog of the reference's
CPU dispatcher (setupdll.cpp:195-270, viterbi_helpers.asm:48-157).

Where the reference probes CPUID/xgetbv and picks the best of five SIMD
kernels behind a function pointer (``deconJumpTarget``), we probe the
JAX backend (platform, GPU generation, device count) and pick the best
decoder *variant*. This module is the one place that decides which
decode kernel runs; every caller asks it. Override semantics match the
reference: a config override is honored only "downward-compatible" —
forcing a variant the backend can't run keeps the automatic choice
(setupdll.cpp:220-236).

The jump target is re-armed by ``initialize()`` and latched to a
safe-mode stub by the fault handler (runtime.faults), mirroring
``decon_savemode`` (exc_handler.cpp:214,243).
"""

from __future__ import annotations

import dataclasses
import os

import jax

from . import config as config_mod

# Capability bits (analog of getcpucaps.h:29-38).
CAP_JAX = 1 << 0          # basic jitted decode available
CAP_BLOCKED_TB = 1 << 1   # block-parallel traceback
CAP_FUSED = 1 << 2        # fused CUDA decode kernel (Hopper, sm_90)
CAP_GPU = 1 << 3          # running on an NVIDIA GPU
CAP_MULTI_DEVICE = 1 << 4  # >1 addressable device (sharded decode)

# Variant table, "weakest" to "strongest" (analog of the SSE2..AVX512
# ladder). Index is what the config file's byte 0 selects.
VARIANTS = (
    "jax_scan",      # 0: XLA ACS + serial-scan traceback
    "jax_blocked",   # 1: XLA ACS + block-parallel traceback
    "retired",       # 2: no kernel on any platform (keeps auto choice)
    "cuda_fused",    # 3: fused ACS + traceback CUDA kernel (Hopper)
    "auto_best",     # 4: alias: the best supported variant
)


def get_caps() -> int:
    """Probe backend capabilities. Analog of GetCPUCaps. A backend that
    fails to initialize raises: it is never reported as "no devices"."""
    caps = CAP_JAX | CAP_BLOCKED_TB
    devices = jax.devices()
    dev = devices[0]
    if dev.platform == "gpu":
        caps |= CAP_GPU
        # the kernel is built for sm_90a: Hopper only
        if str(getattr(dev, "compute_capability", "")).startswith("9."):
            caps |= CAP_FUSED
    if len(devices) > 1:
        caps |= CAP_MULTI_DEVICE
    return caps


def _variant_supported(index: int, caps: int) -> bool:
    if index in (0, 1):
        return bool(caps & CAP_JAX)
    if index == 3:
        return bool(caps & CAP_FUSED)
    return index == 4


def _best_variant(caps: int) -> int:
    # cuda_fused: one kernel launch per batch, measured faster than the
    # XLA loop on the H100 (docs/KERNELS.md)
    for index in (3, 1, 0):
        if _variant_supported(index, caps):
            return index
    return 0


def best_variant() -> str:
    """Name of the best variant this backend supports."""
    return VARIANTS[_best_variant(get_caps())]


@dataclasses.dataclass
class DispatchState:
    """The mutable dispatcher: chosen variant + safe-mode latch.

    Mirrors VITDLLMEM + deconJumpTarget (viterbi.h:117-129,
    setupdll.cpp:39).
    """
    caps: int = 0
    variant: int = 0
    ready: bool = False         # setup() has run
    safe_mode: bool = False     # latched by faults, cleared by initialize()
    except_counter: int = 0
    config: config_mod.Config = dataclasses.field(
        default_factory=config_mod.Config)


_STATE = DispatchState()


def state() -> DispatchState:
    return _STATE


def variant() -> str:
    """Name of the selected variant (configuring on first use)."""
    if not _STATE.ready:
        setup()
    return VARIANTS[_STATE.variant]


def apply_compile_cache(cfg: config_mod.Config | None = None) -> None:
    """Point JAX's persistent compilation cache at one directory, so a
    restart re-hits every compiled decode shape (the cross-restart half
    of WakeUpYMM's job). ``JAX_COMPILATION_CACHE_DIR``, when set, wins
    and nothing else is set; otherwise a directory the process already
    chose is kept; otherwise the config's ``compile_cache`` (default
    ``<repo>/.jax_cache``) is used, and an empty value disables it."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    if jax.config.jax_compilation_cache_dir:
        return
    cfg = cfg or config_mod.load()
    if not cfg.compile_cache:
        return
    os.makedirs(cfg.compile_cache, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cfg.compile_cache)


def setup(config_path: str | None = None) -> DispatchState:
    """(Re)configure the dispatcher: probe caps, read config, pick the
    variant. Analog of SetupDLL + SetupCpuDispatcher (setupdll.cpp:57-270).
    """
    cfg = config_mod.load(config_path)
    apply_compile_cache(cfg)
    caps = get_caps()
    best = _best_variant(caps)
    variant_index = best
    if 0 <= cfg.variant_override <= 3 \
            and _variant_supported(cfg.variant_override, caps):
        variant_index = cfg.variant_override  # downgrade always honored
    # '4' and unsupported upgrade requests keep the automatic choice
    _STATE.caps = caps
    _STATE.variant = variant_index
    _STATE.config = cfg
    _STATE.safe_mode = False
    _STATE.ready = True
    if cfg.show_info:
        print(f"[viterbi_tpu] variant={VARIANTS[variant_index]} "
              f"caps=0x{caps:x}")
    return _STATE


def initialize(config_path: str | None = None) -> bool:
    """Public re-init: clears the exception counter and safe-mode latch
    and re-reads the config — the twin of the DLL's ``initialize``
    export (dllmain.cpp:156-160).
    """
    _STATE.except_counter = 0
    setup(config_path)
    return True


def latch_safe_mode(exc: BaseException | None = None) -> None:
    """Degrade to safe mode: decode calls return error code 1 until
    ``initialize()`` re-arms (exc_handler.cpp:214,243)."""
    _STATE.safe_mode = True
    _STATE.except_counter += 1
