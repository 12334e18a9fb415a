"""The encoder as its users run it, at sizes whose check needs the blocked
reference: `encode.py`'s loop (GOPs of the synthetic RD clip, coded frame
by frame, back to back, through the port's library entry points; the
window's first K-frame and first P-frame checked at steps 1 and
`check_steps`) with one change, the reference. Its represent and QAT steps
render through `reference/splats_blocked.py` and `qat_blocked.py`: the
same arithmetic as `splats.py` and `qat.py`, its gradient worked out chunk
by chunk, so the reference's peak memory is one chunk's graph whatever
the frame's pair count (3840x2160 at 100,000 splats: ~8e8 (pixel, pair)
values a render).
"""

from __future__ import annotations

import torch

from benchmark.loops import encode
from benchmark.loops.encode import (  # noqa: F401  (the loop's interface)
    CARD_FAULTS,
    FAULTS,
    TINY_TRAFFIC,
    State,
    compare,
    free,
    outputs,
    setup,
    trace_counts,
    window,
)
from benchmark.reference import qat, qat_blocked, splats, splats_blocked


def reference(run, st: State, dtype, control: bool = False) -> dict:
    """`encode.reference` on the blocked render: the reference's readings
    from the same inputs, in `dtype`; with `control`, the codes are the
    reference's own, worked out in `dtype`."""
    c = run.config
    dev = run.device
    tb_x, tb_y = splats.grid(c["height"], c["width"])
    steps = run.traffic["check_steps"]
    at = (0, steps - 1)  # the readings of steps 1 and check_steps
    frames = []
    for f, r in enumerate(st.record):
        init, alive, revived = encode._represent_start(run, r, f)
        fit = splats_blocked.represent_steps(init, alive, st.clip[f], r["budget"], steps,
                                             c["lr"], dtype, revived)
        n = r["gmodel"]["_xyz"].shape[0]
        g = encode._draws(run.seed, f, 2)
        picks = [torch.randperm(n, generator=g)[:qat.CODEBOOK].to(dev)
                 for _ in range(qat.STAGES)]
        qbudget = splats.default_budget(n, tb_x * tb_y, c["compress_budget_factor"])
        q = qat_blocked.qat_steps(r["gmodel"], r["previous"] if f else None, st.clip[f],
                                  qbudget, picks, steps, c["lr"], dtype)
        frames.append({
            "losses": [fit.losses[i] for i in at], "first_grads": fit.first_grads,
            "leaves": [fit.start] + [fit.after[i] for i in at],
            "qat_losses": [q.losses[i] for i in at],
            "qat_leaves": [q.start] + [q.after[i] for i in at],
            "codebooks": [q.embeds[i] for i in at],
        })
    code_dtype = dtype if control else torch.float64
    codes = [qat.frame_codes(h["xyz"], h["cholesky"], h["features_dc"], h["q_scale"],
                             h["q_beta"], h["embed"], code_dtype)._asdict()
             for _blob, h in st.coded]
    return {"frames": frames, "codes": codes}
