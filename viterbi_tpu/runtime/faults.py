"""Failure detection & elastic recovery — the analog of the reference's
vectored-exception-handler subsystem (exc_handler.cpp:150-250,
SURVEY.md §5).

The reference survives access violations and stack overflows inside its
kernels by binary-patching the fault away and latching the dispatcher to
a safe no-op decoder until ``initialize()`` re-arms it. The equivalents
here are:

  * input validation before dispatch, split into two classes the way
    the reference's address-range attribution splits faults
    (exc_handler.cpp:195,229-231):
      - ``CrashError`` — inputs that *would have faulted inside* the
        reference's kernels (null buffers): return the error code AND
        latch safe mode, exactly like the VEH path;
      - ``ValidationError`` — benign caller typos (bad framebits, short
        buffers) that a Python caller can make without any analog of a
        hardware fault: return the error code WITHOUT latching, so one
        caller's typo cannot degrade every other caller;
  * a catch-all around kernel execution that converts any *other*
    device or host exception into the latch-and-degrade behavior (the
    fault originated in our code = inside the "DLL address range"),
  * ``initialize()`` clears the latch (runtime.dispatch.initialize).

``guarded`` is the decorator both hot API entry points go through.
"""

from __future__ import annotations

import functools
import threading
import traceback as _tb

from . import dispatch

SAFE_MODE_RETVAL = 1   # decon_savemode's return value (viterbi_helpers.asm)

_last_fault: dict = {"exc": None, "trace": None, "count": 0}
_fault_lock = threading.Lock()


def last_fault() -> dict:
    with _fault_lock:
        return dict(_last_fault)


def record_fault(exc: BaseException) -> None:
    with _fault_lock:
        _last_fault["exc"] = repr(exc)
        _last_fault["trace"] = _tb.format_exc()
        _last_fault["count"] += 1
    dispatch.latch_safe_mode(exc)


def guarded(safe_retval):
    """Wrap an API entry point with validation + latch-on-fault.

    While safe mode is latched, calls return ``safe_retval`` immediately
    (the reference's blocked-until-initialize behavior,
    viterbi-benchmark.cpp:456-464). ``ValidationError`` returns the
    error code without latching; everything else latches.
    """
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if dispatch.state().safe_mode:
                return safe_retval
            try:
                return fn(*args, **kwargs)
            except ValidationError:   # benign typo: error, no latch
                return safe_retval
            except Exception as exc:  # kernel fault: latch, survive
                record_fault(exc)
                return safe_retval
        return wrapper
    return deco


class ValidationError(ValueError):
    """Benign bad input (shape/size typo): error return, no latch."""


class CrashError(RuntimeError):
    """Input that would have faulted inside the reference's kernels
    (null pointers): error return + safe-mode latch, mirroring the
    vectored-exception-handler path."""
