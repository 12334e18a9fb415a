"""CLI policy shared by the represent and compress drivers and the decoder:
the device a run asked for, the refusal of the unported multi-host modes,
the per-frame random generator and the representation checkpoint reader."""

from __future__ import annotations

import os

import numpy as np
import torch

from gsvc_tpu_torch.parallel.multihost import NOT_PORTED


def resolve_device(name: str) -> torch.device:
    """The torch device of `--device`; a CUDA device must exist (there is no
    CPU fallback for a run that asked for the card)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda but no CUDA device is available (use --device cpu)"
        )
    return device


def check_single_host(args) -> None:
    """Refuse the multi-chip and multi-host modes, which are not ported:
    they must never run silently on one device."""
    hosts = args.hosts if args.hosts > 1 else int(os.environ.get("GSVC_NUM_PROCS", "1"))
    if hosts > 1:
        raise NotImplementedError(f"--hosts {hosts} {NOT_PORTED}")
    if args.tile_shards and args.tile_shards > 1:
        raise NotImplementedError(f"--tile_shards {args.tile_shards} {NOT_PORTED}")


def frame_generator(seed: int, frame_num: int) -> torch.Generator:
    """The host generator of frame `frame_num`'s random draws."""
    return torch.Generator().manual_seed(seed * 100003 + frame_num)


def load_gmodels(path: str) -> dict:
    """Load the representation checkpoint ({'frame_{n}/_xyz': ...} npz)
    into {frame_n: gmodel_dict} of numpy arrays."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            frame, name = key.split("/", 1)
            out.setdefault(frame, {})[name] = data[key]
    return out
