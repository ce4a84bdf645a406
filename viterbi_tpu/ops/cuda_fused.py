"""Fused Viterbi decode on NVIDIA Hopper through JAX's foreign function
interface: the ACS trellis loop and the traceback of each frame run in
one CUDA thread (``cuda/viterbi_fused.cu``), so no per-step launches and
no decisions round trip through XLA.

The library is compiled from the repository's source with ``nvcc`` for
``sm_90a`` at first use, into ``<repo>/.build/`` under a name that
carries a hash of the source and flags, so an edited source is rebuilt
and a stale binary is never loaded. ``python -m viterbi_tpu.ops.cuda_fused``
builds it ahead of time. A failed build raises ``BuildError``; nothing
falls back silently.

Around the kernel everything is XLA and runs on any backend: ``prepare``
packs the soft symbols to one word per trellis step, time-major, with
the time axis padded to the kernel's prefetch block and the batch to a
warp; ``finish`` turns the kernel's MSB-first bit words into bytes. The
same per-frame C++ code also builds for the host (``build_host_library``
/ ``decode_host``), which is how the CPU tests check the kernel's
arithmetic against the golden model.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from . import packing

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda",
                      "viterbi_fused.cu")
BUILD_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                         "..", ".build"))
TARGET = "viterbi_fused_decode"
BLOCK = 16     # kBlock in the kernel: the time axis is padded to it
WARP = 32      # the batch axis is padded to whole warps
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
HOST_FLAGS = ("-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_registered = False


class BuildError(RuntimeError):
    """The kernel library could not be compiled."""


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin``."""
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def _build(compiler: list[str], flags: tuple[str, ...], stem: str) -> str:
    """Compile SOURCE into BUILD_DIR/<stem>-<hash>.so unless that exact
    build exists; the hash covers the source bytes and every flag."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + "\0".join(compiler[1:] + list(flags))
                         .encode()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"{stem}-{key}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [*compiler, *flags, "-o", tmp, SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            raise BuildError(f"{' '.join(cmd)} failed "
                             f"({proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, path)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise BuildError(f"{' '.join(cmd)}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def build_library() -> str:
    """Build (if needed) the CUDA library; returns its path."""
    return _build([nvcc(), "-I", jax.ffi.include_dir()], NVCC_FLAGS,
                  "libviterbi_fused")


def build_host_library() -> str:
    """Build (if needed) the host version of the per-frame code."""
    return _build([os.environ.get("CXX", "c++")], HOST_FLAGS,
                  "libviterbi_fused_host")


def _register() -> None:
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build_library())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.ViterbiFusedDecode),
            platform="CUDA")
        _registered = True


def prepare(symbols: jax.Array, framebits: int,
            packed: bool = False) -> jax.Array:
    """Kernel input: uint32[T, Bp] one word per step, time-major, T =
    framebits+6 rounded up to BLOCK, Bp = batch rounded up to WARP.

    ``symbols``: [B, >=4*(framebits+6)] soft symbols, or with ``packed``
    [B, >=framebits+6] words from ``packing.pack_symbols_host``.
    """
    nsteps = framebits + C.TAIL_BITS
    B = symbols.shape[0]
    if packed:
        words = symbols[:, :nsteps].astype(jnp.int32)
    else:
        words = packing.pack_symbols(symbols, nsteps)
    T = -(-nsteps // BLOCK) * BLOCK
    Bp = max(WARP, -(-B // WARP) * WARP)
    words = jnp.pad(words, ((0, Bp - B), (0, T - nsteps)))
    return jax.lax.bitcast_convert_type(words.T, jnp.uint32)


def finish(words: jax.Array, framebits: int, batch: int) -> jax.Array:
    """uint32[ceil(framebits/32), Bp] MSB-first bit words ->
    uint8[batch, ceil(framebits/8)] bytes (np.packbits order)."""
    w = words.T[:batch]
    b = jnp.stack([w >> 24, w >> 16, w >> 8, w], axis=-1) & 0xFF
    return b.reshape(batch, -1)[:, : -(-framebits // 8)].astype(jnp.uint8)


@functools.partial(jax.jit, static_argnames=("framebits", "packed"))
def decode(symbols: jax.Array, framebits: int,
           packed: bool = False) -> jax.Array:
    """Decode a batch on the GPU: [B, 4*(framebits+6)] soft symbols (or
    packed words, see ``prepare``) -> uint8[B, ceil(framebits/8)]."""
    _register()
    syms = prepare(symbols, framebits, packed)
    T, Bp = syms.shape
    nwords = -(-framebits // 32)
    words, _ = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((nwords, Bp), jnp.uint32),
         jax.ShapeDtypeStruct((T, 2, Bp), jnp.uint32)),   # decisions
    )(syms, nsteps=np.int64(framebits + C.TAIL_BITS),
      nframes=np.int64(symbols.shape[0]))
    return finish(words, framebits, symbols.shape[0])


def decode_host(symbols, framebits: int, packed: bool = False) -> np.ndarray:
    """``decode`` with the kernel's per-frame code compiled for the host
    in place of the CUDA launch — the CPU tests' view of the kernel."""
    lib = ctypes.CDLL(build_host_library())
    B = np.shape(symbols)[0]
    syms = np.ascontiguousarray(
        prepare(jnp.asarray(symbols), framebits, packed))
    T, Bp = syms.shape
    out = np.zeros((-(-framebits // 32), Bp), np.uint32)
    dec = np.zeros((T, 2, Bp), np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.vit_decode_host.argtypes = [u32p, u32p, u32p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_int,
                                    ctypes.c_int]
    lib.vit_decode_host.restype = None
    lib.vit_decode_host(syms.ctypes.data_as(u32p), dec.ctypes.data_as(u32p),
                        out.ctypes.data_as(u32p), Bp, B,
                        framebits + C.TAIL_BITS, T // BLOCK)
    return np.asarray(finish(jnp.asarray(out), framebits, B))


if __name__ == "__main__":
    print(build_library())
