"""rANS entropy coding for categorical symbol streams (numpy).

A copy of the numpy codec of gsvc_tpu/compress/entropy.py, so the port
writes and reads the same bytes without importing the JAX package:
streaming rANS, 64-bit state, 32-bit renormalised words, probabilities
quantised to PRECISION=16 bits, encoded in reverse so decoding is a
forward scan. The native C++ loader of the JAX package is not ported yet.
"""

from __future__ import annotations

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


def compress_matrix_flatten_categorical(matrix):
    """Flat int sequence -> (compressed uint32 words, counts, unique values)
    (reference quantize.py:152-168)."""
    arr = np.asarray(matrix).flatten()
    unique, inverse, counts = np.unique(arr, return_inverse=True, return_counts=True)
    unique = unique.astype(judge_type(unique.min(), unique.max()))
    pmf_q = _quantize_pmf(counts)
    return _encode(inverse.astype(np.int32).reshape(-1), pmf_q), counts, unique


def decompress_matrix_flatten_categorical(
    compressed, unique_counts, quant_symbol, symbol_length, symbol_shape
):
    """Inverse of compress_matrix_flatten_categorical (quantize.py:170-180)."""
    pmf_q = _quantize_pmf(np.asarray(unique_counts))
    decoded = _decode(np.asarray(compressed, np.uint32), pmf_q, symbol_length)
    return np.asarray(quant_symbol)[decoded].reshape(symbol_shape)
