"""Config file system — behavioral twin of the reference's
``%LOCALAPPDATA%\\viterbi\\viterbi.txt`` (setupdll.cpp:57-193,
inifiletext.h:12-31).

Semantics preserved:
  * a self-documenting template is written on first run,
  * the first line's first byte selects the decoder variant ('0'-'4',
    anything else = automatic), third byte toggles the info banner —
    positionally parsed exactly like the reference's 3-byte "x:x",
  * the file is re-read on every ``initialize()`` so changes apply
    without restarting the host (dllmain.cpp:153-160),
  * the auto-tuner (harness.benchmark) writes the fastest variant's
    index into byte 0 (viterbi-benchmark.cpp:584-602).

Extension: optional ``key=value`` lines after the first (traceback
block size, call logging, compile cache) — unknown keys are ignored so
the file stays forward-compatible.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

CONFIG_ENV = "VITERBI_TPU_CONFIG"

_TEMPLATE = """\
a:0
# viterbi_tpu configuration.
#
# Line 1, byte 0: decoder variant override.
#   '0'..'4' force a variant index (see `viterbi_tpu.runtime.dispatch`
#   VARIANTS: 0 jax_scan, 1 jax_blocked, 2 retired, 3 cuda_fused,
#   4 auto_best; downgrades always honored, an index this backend has
#   no kernel for keeps the automatic choice), any other character =
#   automatic selection.
# Line 1, byte 2: '1' prints the chosen variant at initialize().
#
# Optional key=value lines (defaults shown):
# traceback_block=64
# log_calls=0
# log_symbols=0
# compile_cache=1  (persist XLA compilations across processes so a
#                   receiver restart skips recompilation; set 0 to
#                   disable or a path to relocate the cache; the
#                   default is <repo>/.jax_cache, and a set
#                   JAX_COMPILATION_CACHE_DIR overrides this key)
"""


def default_path() -> str:
    override = os.environ.get(CONFIG_ENV)
    if override:
        return override
    base = os.environ.get("XDG_CONFIG_HOME",
                          os.path.join(os.path.expanduser("~"), ".config"))
    return os.path.join(base, "viterbi_tpu", "viterbi.txt")


def default_compile_cache_dir() -> str:
    """``.jax_cache`` at the repository root (a fixed path: the path is
    part of the cache's key)."""
    return os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                        "..", ".jax_cache"))


@dataclass
class Config:
    variant_override: int = -1     # -1 = automatic
    show_info: bool = False
    traceback_block: int = 64
    log_calls: bool = False
    log_symbols: bool = False
    # persistent XLA compilation cache: "" disables, otherwise a dir
    compile_cache: str = field(default_factory=default_compile_cache_dir)
    path: str = field(default_factory=default_path)


def ensure_config_file(path: str | None = None) -> str:
    path = path or default_path()
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(_TEMPLATE)
    return path


def load(path: str | None = None) -> Config:
    """Read the config file (creating the template on first run)."""
    path = ensure_config_file(path)
    cfg = Config(path=path)
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return cfg
    if lines:
        first = lines[0]
        if len(first) >= 1 and "0" <= first[0] <= "4":
            cfg.variant_override = ord(first[0]) - ord("0")
        if len(first) >= 3 and first[2] == "1":
            cfg.show_info = True
    for line in lines[1:]:
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if key == "traceback_block":
            try:
                cfg.traceback_block = max(8, int(val))
            except ValueError:
                pass
        elif key == "log_calls":
            cfg.log_calls = val not in ("0", "false", "")
        elif key == "log_symbols":
            cfg.log_symbols = val not in ("0", "false", "")
        elif key == "compile_cache":
            if val.lower() in ("0", "false", "no", ""):
                cfg.compile_cache = ""
            elif val.lower() in ("1", "true", "yes"):
                # boolean-ish truthy spellings mean the default dir —
                # without this, "compile_cache=true" would silently
                # create a cache directory literally named "true"
                cfg.compile_cache = default_compile_cache_dir()
            else:
                cfg.compile_cache = val
    return cfg


def write_variant(index: int, path: str | None = None) -> None:
    """Auto-tuner hook: persist the winning variant into byte 0."""
    path = ensure_config_file(path)
    with open(path) as f:
        content = f.read()
    first_nl = content.find("\n")
    first = content[:first_nl] if first_nl >= 0 else content
    rest = content[first_nl:] if first_nl >= 0 else ""
    ch = str(index) if 0 <= index <= 4 else "a"
    first = ch + (first[1:] if len(first) > 1 else ":0")
    with open(path, "w") as f:
        f.write(first + rest)
