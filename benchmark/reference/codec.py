"""Plain reader of a coded frame: the container and its rANS streams.

Frozen copies at commit a2bb42d of gsvc_tpu_torch/compress/bitstream.py
`decode_frame`'s container parse and gsvc_tpu_torch/compress/entropy.py's
numpy codec (`_quantize_pmf`, `_decode`): streaming rANS with a 64-bit
state, 32-bit words and probabilities quantised to 16 bits.
"""

from __future__ import annotations

import numpy as np

PRECISION = 16
_SCALE = 1 << PRECISION
_STATE_LO = 1 << 32


def _quantize_pmf(counts: np.ndarray) -> np.ndarray:
    counts = counts.astype(np.float64)
    q = np.maximum(1, np.round(counts / counts.sum() * _SCALE)).astype(np.int64)
    diff = _SCALE - q.sum()
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


def _decode(words: np.ndarray, pmf: np.ndarray, n: int) -> np.ndarray:
    cdf = np.zeros(len(pmf) + 1, np.int64)
    np.cumsum(pmf, out=cdf[1:])
    lut = np.zeros(_SCALE, np.int32)
    for s in range(len(pmf)):
        lut[cdf[s]:cdf[s + 1]] = s
    pos = len(words) - 1
    state = (int(words[pos]) << 32) | int(words[pos - 1])
    pos -= 2
    out = np.empty(n, np.int32)
    for i in range(n):
        slot = state & (_SCALE - 1)
        s = int(lut[slot])
        state = int(pmf[s]) * (state >> PRECISION) + slot - int(cdf[s])
        while state < _STATE_LO and pos >= 0:
            state = (state << 32) | int(words[pos])
            pos -= 1
        out[i] = s
    return out


def read_frame(blob: bytes) -> dict:
    """The codes of a coded frame: xyz16 [N, 2], q_scale, q_beta [3],
    chol_codes [N, 3], embed [Q, K, 3], indices [N, Q], frame_type."""
    buf = memoryview(blob)
    off = 0

    def take(k):
        nonlocal off
        v = buf[off:off + k]
        off += k
        return v

    def get():
        dl = int(np.frombuffer(take(1), np.uint8)[0])
        dt = np.dtype(bytes(take(dl)).decode())
        ln = int(np.frombuffer(take(4), np.uint32)[0])
        return np.frombuffer(take(ln), dt).copy()

    def symbols(words, counts, unique, n, shape):
        dec = _decode(np.asarray(words, np.uint32), _quantize_pmf(np.asarray(counts)), n)
        return np.asarray(unique)[dec].reshape(shape).astype(np.int64)

    n, q, k = (int(np.frombuffer(take(4), np.uint32)[0]) for _ in range(3))
    xyz16 = get().reshape(n, 2)
    q_scale, q_beta = get(), get()
    c = get(), get(), get()
    embed = get().reshape(q, k, 3)
    i = get(), get(), get()
    trailer = bytes(buf[off:])
    return {
        "xyz16": xyz16, "q_scale": q_scale, "q_beta": q_beta,
        "chol_codes": symbols(*c, n * 3, (n, 3)), "embed": embed,
        "indices": symbols(*i, q * n, (n, q)),
        "frame_type": chr(trailer[-1]) if trailer[:4] == b"GSV1" else None,
    }
