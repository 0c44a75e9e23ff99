"""ctypes loader for the fused quantization kernels (quant.cc).

Same build discipline as ``_native/store.py``: the bundled source is
compiled by ``g++`` on first use into ``ray_tpu_torch/_build/``, under a
name that hashes the source and the flags (flock-guarded, so concurrent
workers build it once).  ``lib()`` returns None when no compiler is
available — the numpy reference path in ``util/collective/quantize.py``
is always there, and both produce bit-identical wire bytes (quant.cc
builds with -ffp-contract=off for exactly that reason).  These are host
codecs for the collectives' wire format, not device kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "quant.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_CXX_FLAGS = ("-O3", "-ffp-contract=off", "-fno-math-errno", "-fPIC", "-shared", "-std=c++17")

_lib = None
_lib_lock = threading.Lock()


def library_path() -> str:
    """Where the codec library is built: ``ray_tpu_torch/_build/``, under a
    name that hashes the source and the flags.  No library is kept in the
    repository."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libquant-{h.hexdigest()[:16]}.so")


def _build_library() -> str:
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(so + ".lock", "w") as lf:
        import fcntl

        fcntl.flock(lf, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        tmp = f"{so}.tmp{os.getpid()}"
        # -march=native is safe here: the library is always compiled on
        # the host that loads it, and it unlocks the wide-SIMD quant
        # loops.  Retry without it for toolchains that reject the flag.
        cmd = ["g++", *_CXX_FLAGS, _SRC, "-o", tmp]
        try:
            subprocess.run(cmd[:1] + ["-march=native"] + cmd[1:], check=True, capture_output=True)
        except subprocess.CalledProcessError:
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def _bind(lib) -> None:
    i64, fp, i8p, u16p, u32p = (
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int8),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint32),
    )
    lib.rt_quant_int8_encode.restype = ctypes.c_int
    lib.rt_quant_int8_encode.argtypes = [fp, i64, i64, fp, i8p]
    lib.rt_quant_int8_decode.restype = None
    lib.rt_quant_int8_decode.argtypes = [fp, i8p, i64, i64, fp]
    lib.rt_quant_int8_decode_add.restype = None
    lib.rt_quant_int8_decode_add.argtypes = [fp, i8p, i64, i64, fp]
    lib.rt_quant_bf16_encode.restype = ctypes.c_int
    lib.rt_quant_bf16_encode.argtypes = [u32p, i64, u16p]
    lib.rt_quant_bf16_decode.restype = None
    lib.rt_quant_bf16_decode.argtypes = [u16p, i64, u32p]
    lib.rt_quant_bf16_decode_add.restype = None
    lib.rt_quant_bf16_decode_add.argtypes = [u16p, i64, fp]


def lib():
    """The loaded kernel library, or None when it cannot be built
    (no compiler in the image): callers take the numpy path."""
    global _lib
    if _lib is False:
        return None
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                try:
                    loaded = ctypes.CDLL(_build_library())
                    _bind(loaded)
                    _lib = loaded
                except Exception:
                    _lib = False
                    return None
    return _lib or None
