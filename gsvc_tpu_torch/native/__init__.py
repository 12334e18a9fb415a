"""The port's native (C++) host code, loaded with ctypes: the rANS codec
(`rans.cpp`) and the I420 -> RGB converter (`yuv.cpp`), copies of
gsvc_tpu/native's with the same C ABI and results.

`rans_lib()` and `yuv_lib()` (the JAX package's names) compile their
source with g++ at first use into gsvc_tpu_torch/build/
(`_build.py`: content hash, file lock) and bind its entry points
(`_build.bind`). A failed
build raises with g++'s output: nothing falls back to numpy on its own.
The numpy versions stay as the plain versions, chosen only by the callers'
`native=False`.
"""

from __future__ import annotations

import ctypes

from gsvc_tpu_torch import _build


_U8P, _U32P = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint32)
_I32P, _I64P = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
_SIZE = ctypes.c_size_t


def rans_lib() -> ctypes.CDLL:
    """The rANS library: `rans_encode` and `rans_decode`."""
    return _build.bind("rans", {
        "rans_encode": (_SIZE, [_I32P, _SIZE, _I64P, _SIZE, _U32P, _SIZE]),
        "rans_decode": (ctypes.c_int, [_U32P, _SIZE, _I64P, _SIZE, _SIZE, _I32P])})


def yuv_lib() -> ctypes.CDLL:
    """The I420 library: `yuv420_to_rgb`."""
    return _build.bind("yuv", {
        "yuv420_to_rgb": (None, [_U8P, ctypes.c_int, ctypes.c_int, _U8P])})
