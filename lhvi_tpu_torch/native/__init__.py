"""Native (C++) host code of the port, loaded with ``ctypes``.

``libfastlift`` is the colour-refinement core (``fastlift.cpp``, a copy of
the JAX package's). It is built with the system ``g++`` at first use into
``lhvi_tpu_torch/ops/_build/``, under a name keyed by a hash of the source
and flags, so an edited source rebuilds and an unchanged one is reused.
A failed build raises with the compiler's output: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_SRC = Path(__file__).parent / "fastlift.cpp"
_BUILD = Path(__file__).parent.parent / "ops" / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    """The built library's path for the current source (built if absent)."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(_SRC.read_bytes())
    out = _BUILD / f"libfastlift_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: concurrent first uses (test
    # workers) never load a half-written library
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
    r = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({r.returncode}) building "
                           f"{_SRC.name}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def load_fastlift() -> ctypes.CDLL:
    """The loaded colour-refinement library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(library_path()))
            lib.lhvi_color_refine.restype = ctypes.c_int64
            lib.lhvi_color_refine.argtypes = [
                ctypes.c_int64,  # n_rv
                ctypes.c_int64,  # n_f
                ctypes.POINTER(ctypes.c_int64),  # f_off
                ctypes.POINTER(ctypes.c_int32),  # f_rvs
                ctypes.POINTER(ctypes.c_uint8),  # f_sym
                ctypes.POINTER(ctypes.c_int32),  # rv_color
                ctypes.POINTER(ctypes.c_int32),  # f_color
                ctypes.c_int64,  # max_rounds
            ]
            _lib = lib
        return _lib
