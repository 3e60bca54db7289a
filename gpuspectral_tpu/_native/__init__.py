"""ctypes bindings for the native IO library (native/).

Provides `lib` (the loaded shared library) or None when unavailable; callers
fall back to pure-Python implementations.  The library is not tracked: the
first use builds it from native/ with native/Makefile into this directory
(`make -C native` does the same by hand).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libgsnative.so")
_REPO = os.path.dirname(os.path.dirname(_DIR))

lib = None


def _build() -> None:
    """Compile into a per-process temporary name and rename it into place,
    so concurrent first uses never load a half-written library."""
    native = os.path.join(_REPO, "native")
    if not os.path.exists(os.path.join(native, "Makefile")):
        return
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-C", native, "-B", f"OUT={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    except (OSError, subprocess.SubprocessError):
        pass
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _try_load():
    global lib
    if lib is not None:
        return lib
    if not os.path.exists(_SO):
        _build()
    if not os.path.exists(_SO):
        return None
    try:
        l = ctypes.CDLL(_SO)
    except OSError:
        return None
    l.obj_parse.restype = ctypes.c_long
    l.obj_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    l.obj_fill.restype = None
    l.obj_fill.argtypes = [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_float)] * 3
    l.obj_free.restype = None
    l.obj_free.argtypes = [ctypes.c_void_p]
    l.piz_decode.restype = ctypes.c_int
    l.piz_decode.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16),
    ]
    lib = l
    return lib


def get_lib():
    return _try_load()
