"""viterbi_tpu — a DAB forward-error-correction framework in JAX.

A from-scratch JAX/XLA rebuild, with a CUDA decode kernel for Hopper
GPUs, of the capabilities of
``viterbi.dll`` (the SIMD FEC engine of the QIRX-SDR DAB/DAB+ receiver):

  * ``deconvolve`` — soft-decision Viterbi decoding of the DAB mother
    code (K=7, rate 1/4, 64 states), batched over frames and sharded
    over device meshes,
  * ``rs_check_superframe`` — RS(120,110) GF(256) superframe
    check/correct, vectorized over interleaved codewords,
  * lifecycle/config: ``initialize``, ``get_caps``, ``wake_up``.

See SURVEY.md for the structural map of the reference and the layer
correspondence.
"""

from . import constants  # noqa: F401
from . import golden     # noqa: F401
from .api import (  # noqa: F401
    deconvolve,
    deconvolve_batch,
    get_caps,
    initialize,
    last_output,
    last_rs_output,
    rs_check_superframe,
    wake_up,
)

__version__ = "0.1.0"
