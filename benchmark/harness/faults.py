"""Faults planted in the port under the timed path, to show that the
check reads them: each takes `setattr`-like `patch(obj, name, value)`
(pytest's `monkeypatch.setattr`, or `setattr` for a process of
`benchmark/control.py --fault`). A loop lists the faults its cells can
have in its own module (`FAULTS`, `CARD_FAULTS`): these, or faults it
defines itself."""

from __future__ import annotations

import math

import numpy as np


def state_unchanged(patch) -> None:
    """Every represent step leaves the splats as they were."""
    from gsvc_tpu_torch.models import represent
    from gsvc_tpu_torch.optim.adan import adan_host_step

    patch(represent, "adan_step_", lambda params, grads, state, *a, **k: adan_host_step(state))


def half_the_batch(patch) -> None:
    """The loss leaves out the lower half of the frame and takes the mean
    over the rest (the rows loss's mask, x sqrt 2 on the kept half)."""
    from gsvc_tpu_torch.models import represent

    orig = represent.make_rows_target

    def half(gt, cfg, valid_h=None):
        lim = gt.shape[0] // 2 if valid_h is None else min(valid_h, gt.shape[0] // 2)
        rows, mask = orig(gt, cfg, lim)
        return rows, mask * math.sqrt(2.0)

    patch(represent, "make_rows_target", half)


def coded_frame_altered(patch) -> None:
    """The coded frame's means are altered where the bytes are written."""
    from gsvc_tpu_torch.compress import bitstream

    orig = bitstream.pack_frame

    def altered(xyz16, *a, **k):
        return orig(np.asarray(xyz16, np.float16) + np.float16(0.01), *a, **k)

    patch(bitstream, "pack_frame", altered)


def render_altered(patch) -> None:
    """The eval render is dimmed by a tenth where it is produced."""
    from gsvc_tpu_torch.models import represent

    orig = represent.render_frame
    patch(represent, "render_frame", lambda *a, **k: orig(*a, **k) * 0.9)


def replay_unchanged(patch) -> None:
    """Every replayed step of a fit leaves its state as it was: the step
    graph's replay is counted and not run (the steps before its capture,
    and the eager control steps, still move the state). Card only: the
    CPU runs every step eagerly."""
    from gsvc_tpu_torch.utils import graphs

    def replay(self) -> None:
        graphs.StepGraph.replays += 1

    patch(graphs.StepGraph, "replay", replay)

