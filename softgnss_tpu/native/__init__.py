"""Native (C++) IO runtime: sample unpackers + probe statistics.

The compute path is JAX/XLA; the byte-level capture decoding that
feeds it is native C++ (softgnss_tpu/native/unpack.cpp), loaded via
ctypes.  The library is compiled on demand with the system toolchain and
cached next to the source; softgnss_tpu.io falls back to the NumPy
implementations when no compiler is available, so the native layer is an
accelerator, never a requirement.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(__file__), "unpack.cpp")
_LIB = os.path.join(os.path.dirname(__file__), "libsgunpack.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", _LIB, _SRC]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError) as exc:
        logger.info("native unpack build failed (%s); using NumPy fallback", exc)
        return False


def load():
    """The ctypes library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        have_src = os.path.exists(_SRC)
        stale = (have_src and os.path.exists(_LIB)
                 and os.path.getmtime(_LIB) < os.path.getmtime(_SRC))
        if not os.path.exists(_LIB) or stale:
            if not have_src or not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError as exc:
            logger.info("native unpack load failed (%s)", exc)
            return None
        u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        i16 = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        for name in ("unpack_int4", "unpack_int2", "unpack_int1"):
            fn = getattr(lib, name)
            fn.argtypes = [u8, i8, ctypes.c_size_t]
            fn.restype = None
        lib.narrow_int16.argtypes = [i16, i8, ctypes.c_size_t]
        lib.narrow_int16.restype = None
        lib.unbias_uint8.argtypes = [u8, i8, ctypes.c_size_t]
        lib.unbias_uint8.restype = None
        lib.probe_stats.argtypes = [i8, ctypes.c_size_t, i64,
                                    ctypes.POINTER(ctypes.c_double),
                                    ctypes.POINTER(ctypes.c_double)]
        lib.probe_stats.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


_SAMPLES_PER_BYTE = {"int4": 2, "int2": 4, "int1": 8}


def unpack(raw: np.ndarray, fmt: str) -> np.ndarray | None:
    """Unpack a uint8 byte array; None if the native library is missing."""
    lib = load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.uint8)
    if fmt in _SAMPLES_PER_BYTE:
        out = np.empty(len(raw) * _SAMPLES_PER_BYTE[fmt], np.int8)
        getattr(lib, f"unpack_{fmt}")(raw, out, len(raw))
        return out
    if fmt == "uint8":
        out = np.empty(len(raw), np.int8)
        lib.unbias_uint8(raw, out, len(raw))
        return out
    return None


def narrow_int16(raw: np.ndarray) -> np.ndarray | None:
    lib = load()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, np.int16)
    out = np.empty(len(raw), np.int8)
    lib.narrow_int16(raw, out, len(raw))
    return out


def probe_stats(samples: np.ndarray) -> dict | None:
    """Single-pass histogram + mean/std of int8 samples; None w/o native."""
    lib = load()
    if lib is None:
        return None
    samples = np.ascontiguousarray(samples, np.int8)
    hist = np.zeros(256, np.int64)
    s = ctypes.c_double()
    s2 = ctypes.c_double()
    lib.probe_stats(samples, len(samples), hist, ctypes.byref(s), ctypes.byref(s2))
    n = len(samples)
    mean = s.value / n if n else 0.0
    var = max(s2.value / n - mean * mean, 0.0) if n else 0.0
    return {"hist": hist, "mean": mean, "std": var ** 0.5}
