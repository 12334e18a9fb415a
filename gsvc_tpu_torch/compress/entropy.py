"""rANS entropy coding for categorical symbol streams.

The codec of gsvc_tpu/compress/entropy.py, so the port writes and reads
the same bytes without importing the JAX package: streaming rANS, 64-bit
state, 32-bit renormalised words, probabilities quantised to PRECISION=16
bits, encoded in reverse so decoding is a forward scan. The public
functions run the native C++ codec (native/rans.cpp, built with g++ at
first use); `_encode` and `_decode`, a copy of the JAX package's numpy
codec that runs one Python step a symbol, are its plain versions, taken
only with `native=False`. A native failure raises: a word buffer too
small (0 words) or a malformed stream (a non-zero return).
"""

from __future__ import annotations

import ctypes

import numpy as np

PRECISION = 16
_PROB_SCALE = 1 << PRECISION
_STATE_LO = 1 << 32


def judge_type(vmin, vmax):
    """Smallest numpy integer dtype covering [vmin, vmax]
    (reference quantize.py:183-197, including its <=256 uint8 off-by-one)."""
    if vmin >= 0:
        if vmax <= 256:
            return np.uint8
        elif vmax <= 65535:
            return np.uint16
        return np.uint32
    if vmax < 128 and vmin >= -128:
        return np.int8
    if vmax < 32768 and vmin >= -32768:
        return np.int16
    return np.int32


def get_np_size(x: np.ndarray) -> int:
    return x.size * x.itemsize


def _quantize_pmf(counts: np.ndarray) -> np.ndarray:
    """Counts -> integer pmf summing to 2^PRECISION, every symbol >= 1."""
    counts = counts.astype(np.float64)
    pmf = counts / counts.sum()
    q = np.maximum(1, np.round(pmf * _PROB_SCALE)).astype(np.int64)
    diff = _PROB_SCALE - q.sum()
    order = np.argsort(-q)
    i = 0
    while diff != 0:
        j = order[i % len(order)]
        step = 1 if diff > 0 else -1
        if q[j] + step >= 1:
            q[j] += step
            diff -= step
        i += 1
    return q


def _encode(message: np.ndarray, pmf_q: np.ndarray) -> np.ndarray:
    cdf = np.zeros(len(pmf_q) + 1, np.int64)
    np.cumsum(pmf_q, out=cdf[1:])
    state = _STATE_LO
    words = []
    for s in message[::-1]:
        freq = int(pmf_q[s])
        # keep state in [2^32, freq * 2^48) before the push
        while state >= (freq << 48):
            words.append(state & 0xFFFFFFFF)
            state >>= 32
        state = ((state // freq) << PRECISION) + (state % freq) + int(cdf[s])
    words.append(state & 0xFFFFFFFF)
    words.append((state >> 32) & 0xFFFFFFFF)
    return np.asarray(words, np.uint32)


def _decode(words: np.ndarray, pmf_q: np.ndarray, n: int) -> np.ndarray:
    cdf = np.zeros(len(pmf_q) + 1, np.int64)
    np.cumsum(pmf_q, out=cdf[1:])
    lut = np.zeros(_PROB_SCALE, np.int32)
    for s in range(len(pmf_q)):
        lut[cdf[s] : cdf[s + 1]] = s
    pos = len(words) - 1
    state = (int(words[pos]) << 32) | int(words[pos - 1])
    pos -= 2
    out = np.empty(n, np.int32)
    for i in range(n):
        slot = state & (_PROB_SCALE - 1)
        s = int(lut[slot])
        freq = int(pmf_q[s])
        state = freq * (state >> PRECISION) + slot - int(cdf[s])
        while state < _STATE_LO and pos >= 0:
            state = (state << 32) | int(words[pos])
            pos -= 1
        out[i] = s
    return out


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _encode_native(message: np.ndarray, pmf_q: np.ndarray) -> np.ndarray:
    """`_encode` in C++ (native/rans.cpp): the same words."""
    from gsvc_tpu_torch.native import rans_lib

    msg = np.ascontiguousarray(message, np.int32)
    pmf = np.ascontiguousarray(pmf_q, np.int64)
    cap = msg.size + 16  # worst case ~1 word/symbol for a 2^16-quantized pmf
    out = np.empty(cap, np.uint32)
    n = rans_lib().rans_encode(_ptr(msg, ctypes.c_int32), msg.size,
                               _ptr(pmf, ctypes.c_int64), pmf.size,
                               _ptr(out, ctypes.c_uint32), cap)
    if n == 0:
        raise RuntimeError(f"rans_encode: {msg.size} symbols overflowed {cap} words")
    return out[:n].copy()


def _decode_native(words: np.ndarray, pmf_q: np.ndarray, n: int) -> np.ndarray:
    """`_decode` in C++ (native/rans.cpp): the same symbols."""
    from gsvc_tpu_torch.native import rans_lib

    w = np.ascontiguousarray(words, np.uint32)
    pmf = np.ascontiguousarray(pmf_q, np.int64)
    out = np.empty(n, np.int32)
    rc = rans_lib().rans_decode(_ptr(w, ctypes.c_uint32), w.size,
                                _ptr(pmf, ctypes.c_int64), pmf.size,
                                n, _ptr(out, ctypes.c_int32))
    if rc != 0:
        why = {1: "fewer than 2 words", 2: "a pmf that does not sum to 2^16"}
        raise ValueError(f"rans_decode: malformed stream ({why.get(rc, rc)})")
    return out


def compress_matrix_flatten_categorical(matrix, native: bool = True):
    """Flat int sequence -> (compressed uint32 words, counts, unique values)
    (reference quantize.py:152-168); `native=False` encodes with the plain
    numpy codec, which writes the same words."""
    arr = np.asarray(matrix).flatten()
    unique, inverse, counts = np.unique(arr, return_inverse=True, return_counts=True)
    unique = unique.astype(judge_type(unique.min(), unique.max()))
    pmf_q = _quantize_pmf(counts)
    encode = _encode_native if native else _encode
    return encode(inverse.astype(np.int32).reshape(-1), pmf_q), counts, unique


def decompress_matrix_flatten_categorical(
    compressed, unique_counts, quant_symbol, symbol_length, symbol_shape,
    native: bool = True,
):
    """Inverse of compress_matrix_flatten_categorical (quantize.py:170-180);
    `native=False` decodes with the plain numpy codec."""
    pmf_q = _quantize_pmf(np.asarray(unique_counts))
    decode = _decode_native if native else _decode
    decoded = decode(np.asarray(compressed, np.uint32), pmf_q, symbol_length)
    return np.asarray(quant_symbol)[decoded].reshape(symbol_shape)
