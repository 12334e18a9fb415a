"""The port's native (C++) host code, loaded with ctypes: the rANS codec
(`rans.cpp`) and the I420 -> RGB converter (`yuv.cpp`), copies of
gsvc_tpu/native's with the same C ABI and results.

`rans_lib()` and `yuv_lib()` (the JAX package's names) compile their
source with g++ at first use into gsvc_tpu_torch/build/
(`_build.py`: content hash, file lock) and bind its entry points. A failed
build raises with g++'s output: nothing falls back to numpy on its own.
The numpy versions stay as the plain versions, chosen only by the callers'
`native=False`.
"""

from __future__ import annotations

import ctypes

from gsvc_tpu_torch import _build


def rans_lib() -> ctypes.CDLL:
    """The rANS library: `rans_encode` and `rans_decode`."""
    lib = _build.load("rans")
    if not getattr(lib, "_gsvc_bound", False):
        u32p = ctypes.POINTER(ctypes.c_uint32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        size = ctypes.c_size_t
        lib.rans_encode.restype = size
        lib.rans_encode.argtypes = [i32p, size, i64p, size, u32p, size]
        lib.rans_decode.restype = ctypes.c_int
        lib.rans_decode.argtypes = [u32p, size, i64p, size, size, i32p]
        lib._gsvc_bound = True
    return lib


def yuv_lib() -> ctypes.CDLL:
    """The I420 library: `yuv420_to_rgb`."""
    lib = _build.load("yuv")
    if not getattr(lib, "_gsvc_bound", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.yuv420_to_rgb.restype = None
        lib.yuv420_to_rgb.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
        lib._gsvc_bound = True
    return lib
