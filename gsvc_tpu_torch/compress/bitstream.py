"""Frame bitstream (PyTorch port of gsvc_tpu/compress/bitstream.py).

`encode_frame` quantises a fitted `CompressState` and `pack_frame` writes
the container from the numpy codes; `decode_frame` + `render_decoded`
reconstruct a frame from the bytes; on a CUDA device the render is a
replay of a captured CUDA graph, one a splat count and frame size
(`decoded_renderer`, `utils.graphs.RenderCache`), the counterpart of
gsvc_tpu's one jitted render per FrameConfig. The bytes are the JAX
package's: fp16 means, rANS-coded 6-bit cholesky codes with f32
scale/beta, the VQ codebook and rANS-coded stage indices, and a "GSV1" +
K/P trailer. The encoder takes the frame type from its caller; gsvc_tpu infers it from
whether the side information is all zeros, and writes the same bytes
whenever that guess is right.

P-frames carry deltas against the previous frame's representation
checkpoint, which the decoder takes as side information (see the JAX
module's docstring).
"""

from __future__ import annotations

import functools
import io
from typing import Optional

import numpy as np
import torch

from gsvc_tpu_torch.compress.entropy import (
    compress_matrix_flatten_categorical,
    decompress_matrix_flatten_categorical,
)
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.core import CHOLESKY_BOUND
from gsvc_tpu_torch.utils import graphs
from gsvc_tpu_torch.utils.profiling import RECORDER

CHOL_BITS = 6
_RENDERS = graphs.RenderCache(maxsize=8)


def pack_frame(
    xyz16: np.ndarray,
    q_scale: np.ndarray,
    q_beta: np.ndarray,
    chol_codes: np.ndarray,
    embed: np.ndarray,
    indices: np.ndarray,
    frame_type: str = "K",
) -> bytes:
    """Quantised frame -> self-contained byte stream.

    xyz16 [N,2] float16 means (raw, pre-tanh), q_scale / q_beta [3] f32,
    chol_codes [N,3] integer cholesky codes in [0, 2^CHOL_BITS), embed
    [Q,K,3] f32 codebooks, indices [N,Q] integer stage indices, frame_type
    "K" (standalone) or "P" (delta frame).
    """
    if frame_type not in ("K", "P"):
        raise ValueError(f"frame_type must be 'K' or 'P', got {frame_type!r}")
    xyz16 = np.asarray(xyz16, np.float16)
    n = int(xyz16.shape[0])
    embed = np.asarray(embed, np.float32)
    c_comp, c_counts, c_unique = compress_matrix_flatten_categorical(
        np.asarray(chol_codes, np.int32).flatten()
    )
    i_comp, i_counts, i_unique = compress_matrix_flatten_categorical(
        np.asarray(indices, np.int32).flatten()
    )

    out = io.BytesIO()

    def put(arr: np.ndarray):
        arr = np.asarray(arr)
        dt = arr.dtype.str.encode()
        out.write(np.uint8(len(dt)).tobytes())
        out.write(dt)
        raw = arr.tobytes()
        out.write(np.uint32(len(raw)).tobytes())
        out.write(raw)

    out.write(np.uint32(n).tobytes())
    out.write(np.uint32(embed.shape[0]).tobytes())  # Q
    out.write(np.uint32(embed.shape[1]).tobytes())  # K
    put(xyz16)
    put(np.asarray(q_scale, np.float32))
    put(np.asarray(q_beta, np.float32))
    put(c_comp)
    put(c_counts)
    put(c_unique)
    put(embed)
    put(i_comp)
    put(i_counts)
    put(i_unique)
    out.write(b"GSV1" + frame_type.encode())
    return out.getvalue()


def encode_frame(state, cfg: FrameConfig, frame_type: str) -> bytes:
    """A fitted `models.compress.CompressState` -> its byte stream: exactly
    what `measure_bits` counts, in the container of `pack_frame`.
    `frame_type` is "K" (frame mode) or "P" (delta mode); `cfg` gives only
    the config's iterations to the `qat.encode` span it is
    (`utils.profiling.RECORDER`)."""
    from gsvc_tpu_torch.compress.quantizers import (
        UniformQuantParams,
        residual_vq_forward,
        uniform_quantize,
    )

    p = state.params

    def host(t):
        return t.detach().cpu().numpy()

    with RECORDER("qat.encode", device=state.loss.device, splats=p.xyz.shape[0],
                  iterations=cfg.iterations):
        with torch.no_grad():
            _deq, codes = uniform_quantize(
                p.cholesky, UniformQuantParams(scale=p.q_scale, beta=p.q_beta), CHOL_BITS)
            _colors, idx, _l, _ = residual_vq_forward(p.features_dc, state.vq, False)
        return pack_frame(
            host(p.xyz).astype(np.float32).astype(np.float16), host(p.q_scale),
            host(p.q_beta), host(codes), host(state.vq.embed), host(idx), frame_type,
        )


def frame_type(blob: bytes) -> Optional[str]:
    """'K' or 'P' from the trailer; None for streams written before it."""
    if len(blob) >= 5 and blob[-5:-1] == b"GSV1":
        return chr(blob[-1])
    return None


def decode_frame(
    blob: bytes,
    p_xyz: Optional[np.ndarray] = None,
    p_cholesky: Optional[np.ndarray] = None,
    p_features_dc: Optional[np.ndarray] = None,
    native: bool = True,
    times: Optional[dict] = None,
):
    """Bytes -> (means [N,2], cholesky + bound [N,3], colours [N,3]) numpy.

    p_* are the P-frame side-information buffers (None for K-frames).
    `native=False` entropy-decodes with the plain numpy codec. The parse
    and the unpacking are `decode.unpack` spans (`utils.profiling.RECORDER`),
    the rANS decode between them a `decode.entropy` span; `times`, a dict,
    gains their host seconds as "unpack" and "entropy" (the spans are
    `timed`: read where the recorder is off too).
    """
    timed = times is not None
    with RECORDER("decode.unpack", timed=timed) as parse:
        buf = memoryview(blob)
        off = 0

        def take(nbytes):
            nonlocal off
            v = buf[off:off + nbytes]
            off += nbytes
            return v

        def get():
            dl = int(np.frombuffer(take(1), np.uint8)[0])
            dt = np.dtype(bytes(take(dl)).decode())
            ln = int(np.frombuffer(take(4), np.uint32)[0])
            return np.frombuffer(take(ln), dt).copy()

        n = int(np.frombuffer(take(4), np.uint32)[0])
        q = int(np.frombuffer(take(4), np.uint32)[0])
        k = int(np.frombuffer(take(4), np.uint32)[0])
        xyz16 = get().reshape(n, 2)
        q_scale = get()
        q_beta = get()
        c_comp, c_counts, c_unique = get(), get(), get()
        embed = get().reshape(q, k, 3)
        i_comp, i_counts, i_unique = get(), get(), get()

    with RECORDER("decode.entropy", timed=timed) as entropy:
        codes = decompress_matrix_flatten_categorical(
            c_comp, c_counts, c_unique, n * 3, (n, 3), native=native
        ).astype(np.float32)
        idx = decompress_matrix_flatten_categorical(
            i_comp, i_counts, i_unique, q * n, (n, q), native=native
        )
    with RECORDER("decode.unpack", timed=timed) as unpack:
        chol_deq = codes * q_scale[None, :] + q_beta[None, :]
        colors = np.zeros((n, 3), np.float32)
        for s in range(q):
            colors += embed[s][idx[:, s]]

        def side(a, cols):
            return np.zeros((n, cols), np.float32) if a is None else np.asarray(a, np.float32)

        raw = torch.from_numpy(xyz16.astype(np.float32) + side(p_xyz, 2))
        means = torch.tanh(raw).numpy()
        chol = chol_deq + np.asarray(CHOLESKY_BOUND, np.float32) + side(p_cholesky, 3)
        out = means, chol, colors + side(p_features_dc, 3)
    if timed:
        times["entropy"] = times.get("entropy", 0.0) + entropy.host_s
        times["unpack"] = times.get("unpack", 0.0) + parse.host_s + unpack.host_s
    return out


def _render(means, chol, colors, cfg: FrameConfig) -> torch.Tensor:
    """The decoded splats' render: [H, W, 3] clamped to [0, 1]."""
    from gsvc_tpu_torch.ops.projection import project_gaussians_2d
    from gsvc_tpu_torch.ops.rasterize import rasterize_gaussians_sum_clipped

    xys, depths, radii, conics, nth = project_gaussians_2d(
        means, chol, cfg.H, cfg.W, cfg.tile_bounds, cfg.block_w, cfg.block_h,
    )
    opacity = torch.ones((xys.shape[0], 1), dtype=torch.float32, device=xys.device)
    return rasterize_gaussians_sum_clipped(
        xys, depths, radii, conics, nth, colors, opacity,
        cfg.H, cfg.W, cfg.block_h, cfg.block_w,
        backend=cfg.backend, max_intersects=cfg.max_intersects,
    )


def decoded_renderer(n: int, cfg: FrameConfig, device="cpu",
                     graph: Optional[bool] = None) -> graphs.EagerRender:
    """The render of `n` decoded splats on `device`, its inputs means [n, 2],
    cholesky [n, 3] and colours [n, 3] float32 (`load` them, then call it).
    Where `graphs.use_graph(device, graph)`, a RenderGraph from the
    module's cache, keyed by `graphs.render_key`: each distinct splat count
    and frame is captured once a process, and its output is overwritten by
    its next replay. Else an eager render."""
    def inputs():
        return [torch.empty((n, k), dtype=torch.float32, device=device) for k in (2, 3, 3)]

    fn = functools.partial(_render, cfg=cfg)
    if not graphs.use_graph(device, graph):
        return graphs.EagerRender(fn, inputs())
    return _RENDERS.get(graphs.render_key(cfg, n, "image", device),
                        lambda: graphs.RenderGraph(fn, inputs(), device))


def render_decoded(means, chol, colors, cfg: FrameConfig, device="cpu",
                   graph: Optional[bool] = None) -> torch.Tensor:
    """Render decoded splats on `device`: [H, W, 3] clamped to [0, 1]
    (`decoded_renderer`: on a CUDA device a graph replay, whose output the
    next render of the same splat count and frame overwrites)."""
    render = decoded_renderer(np.shape(means)[0], cfg, device, graph)
    render.load(means, chol, colors)
    return render()
