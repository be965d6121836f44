"""Native (C++) host-side components, built on demand with g++.

The compute path is JAX/XLA/Pallas (the array-program analogue of the
reference's C++ kernels); these are the genuinely host-side pieces the
reference also keeps native — snapshot formatting and bulk text parsing
(SURVEY.md section 2 B.7). Loaded lazily via ctypes; every caller has a
pure-Python fallback, so a missing toolchain only costs speed.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import hashlib

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


def _build_and_load():
    src = os.path.join(_HERE, "dumpio.cpp")
    with open(src, "rb") as f:
        tag = hashlib.sha1(f.read()).hexdigest()[:12]
    cache = os.environ.get(
        "SPHERHARM_NATIVE_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(_HERE)), ".native_build"),
    )
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, f"dumpio_{tag}.so")
    if not os.path.exists(so):
        tmp = so + ".tmp"
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, src],
            check=True, capture_output=True,
        )
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.sh_format_dump.restype = ctypes.c_int64
    lib.sh_format_dump.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
        ctypes.c_int64, ctypes.c_char_p,
    ]
    lib.sh_parse_table.restype = ctypes.c_int64
    lib.sh_parse_table.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double),
    ]
    return lib


def get_lib():
    """The native library, or None if the toolchain is unavailable."""
    global _LIB, _TRIED
    if not _TRIED:
        _TRIED = True
        if os.environ.get("SPHERHARM_NO_NATIVE", "0") != "1":
            try:
                _LIB = _build_and_load()
            except Exception:
                _LIB = None
    return _LIB


def format_dump_rows(rows: np.ndarray, int_mask, header: str) -> bytes | None:
    """Format a frame (header + numeric rows) natively; None -> fallback."""
    lib = get_lib()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    n_rows, n_cols = rows.shape
    mask = np.ascontiguousarray(int_mask, dtype=np.int32)
    hdr = header.encode()
    cap = len(hdr) + 32 * n_rows * n_cols + n_rows + 64
    buf = ctypes.create_string_buffer(cap)
    written = lib.sh_format_dump(
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        n_rows, n_cols,
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        hdr, cap, buf,
    )
    if written < 0:
        return None
    return buf.raw[:written]


def parse_table(text: str, n_rows: int, n_cols: int) -> np.ndarray | None:
    """Parse a numeric whitespace table natively; None -> fallback."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((n_rows, n_cols), dtype=np.float64)
    got = lib.sh_parse_table(
        text.encode(), n_rows, n_cols,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    if got != n_rows:
        return None
    return out
