"""ctypes bindings for the native host runtime (native/vitio.cpp).

Runs the repo Makefile (``make -C native``) once per process on first
use, which rebuilds ``libvitio.so`` when ``vitio.cpp`` is newer and is a
no-op otherwise, so a stale library is never loaded. Every entry point
has a NumPy fallback, so the framework works where no compiler or
``make`` is available (``have_native()`` reports which is active).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libvitio.so"))

_lib = None
_lib_lock = threading.Lock()
_built = None          # make's outcome, once per process


def _load():
    global _lib, _built
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _built is None:
            try:
                subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                               capture_output=True, timeout=120, check=True)
                _built = True
            except (OSError, subprocess.SubprocessError):
                _built = False
        if not _built:
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.vit_encode.argtypes = [u8p, ctypes.c_int, u8p]
        lib.vit_pack_bits.argtypes = [u8p, ctypes.c_int, u8p]
        lib.vit_unpack_bits.argtypes = [u8p, ctypes.c_int, u8p]
        lib.vit_rs_deinterleave.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                            u8p]
        lib.vit_rs_interleave.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                          u8p]
        lib.vit_depuncture.argtypes = [u32p, ctypes.c_int, u8p, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_uint32, u32p]
        lib.vit_depuncture.restype = ctypes.c_int
        lib.vit_ring_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.vit_ring_create.restype = ctypes.c_void_p
        lib.vit_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.vit_ring_close.argtypes = [ctypes.c_void_p]
        lib.vit_ring_push.argtypes = [ctypes.c_void_p, u32p, ctypes.c_int64]
        lib.vit_ring_push.restype = ctypes.c_int
        lib.vit_ring_pop_batch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int, u32p, i64p]
        lib.vit_ring_pop_batch.restype = ctypes.c_int
        lib.vit_ring_size.argtypes = [ctypes.c_void_p]
        lib.vit_ring_size.restype = ctypes.c_int
        _lib = lib
        return _lib


def have_native() -> bool:
    return _load() is not None


def _u8(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def encode(bits: np.ndarray) -> np.ndarray:
    """Native twin of golden.encode (hard symbols incl. 6 flush bits)."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    lib = _load()
    if lib is None:
        from .. import golden
        return golden.encode(bits)
    out = np.empty(4 * (bits.size + 6), dtype=np.uint8)
    lib.vit_encode(_u8(bits), bits.size, _u8(out))
    return out


def pack_bits(bits: np.ndarray) -> np.ndarray:
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return np.packbits(bits)
    out = np.empty((bits.size + 7) // 8, dtype=np.uint8)
    lib.vit_pack_bits(_u8(bits), bits.size, _u8(out))
    return out


def depuncture(symbols: np.ndarray, mask: np.ndarray, n_out: int,
               fill: int = 127) -> np.ndarray:
    """Expand punctured soft symbols to the full rate-1/4 stream."""
    symbols = np.ascontiguousarray(symbols, dtype=np.uint32)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    lib = _load()
    if lib is None:
        out = np.full(n_out, fill, dtype=np.uint32)
        tiled = np.tile(mask, -(-n_out // mask.size))[:n_out].astype(bool)
        k = min(int(tiled.sum()), symbols.size)
        idx = np.flatnonzero(tiled)[:k]
        out[idx] = symbols[:k]
        return out
    out = np.empty(n_out, dtype=np.uint32)
    lib.vit_depuncture(_u32(symbols), symbols.size, _u8(mask), mask.size,
                       n_out, fill, _u32(out))
    return out


def rs_deinterleave(p: np.ndarray, rs_dims: int, word_len: int = 120):
    p = np.ascontiguousarray(p, dtype=np.uint8)
    lib = _load()
    if lib is None:
        return p[: rs_dims * word_len].reshape(word_len, rs_dims).T.copy()
    out = np.empty((rs_dims, word_len), dtype=np.uint8)
    lib.vit_rs_deinterleave(_u8(p), rs_dims, word_len, _u8(out))
    return out


class FrameRing:
    """Thread-safe frame ring: producers push frames, a consumer pops
    fixed-size batches for device dispatch (native when available)."""

    def __init__(self, capacity: int, frame_len: int):
        self.frame_len = frame_len
        lib = _load()
        self._lib = lib
        if lib is not None:
            self._h = lib.vit_ring_create(capacity, frame_len)
        else:  # pure-Python fallback
            import collections
            self._q = collections.deque()
            self._cap = capacity
            self._cv = threading.Condition()
            self._closed = False

    def push(self, frame: np.ndarray, tag: int = 0) -> bool:
        frame = np.ascontiguousarray(frame, dtype=np.uint32)
        assert frame.size == self.frame_len
        if self._lib is not None:
            return self._lib.vit_ring_push(self._h, _u32(frame), tag) == 0
        with self._cv:
            while len(self._q) >= self._cap and not self._closed:
                self._cv.wait()
            if self._closed:
                return False
            self._q.append((frame.copy(), tag))
            self._cv.notify_all()
            return True

    def pop_batch(self, batch: int, min_batch: int = 1):
        if self._lib is not None:
            out = np.empty((batch, self.frame_len), dtype=np.uint32)
            tags = np.empty(batch, dtype=np.int64)
            n = self._lib.vit_ring_pop_batch(
                self._h, batch, min_batch,
                _u32(out), tags.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_int64)))
            return out[:n], tags[:n]
        with self._cv:
            while len(self._q) < min_batch and not self._closed:
                self._cv.wait()
            n = min(batch, len(self._q))
            items = [self._q.popleft() for _ in range(n)]
            self._cv.notify_all()
        if not items:
            return (np.empty((0, self.frame_len), np.uint32),
                    np.empty(0, np.int64))
        frames, tags = zip(*items)
        return np.stack(frames), np.asarray(tags, dtype=np.int64)

    def close(self):
        if self._lib is not None:
            self._lib.vit_ring_close(self._h)
        else:
            with self._cv:
                self._closed = True
                self._cv.notify_all()

    def __del__(self):
        try:
            if self._lib is not None:
                self._lib.vit_ring_destroy(self._h)
        except Exception:
            pass
