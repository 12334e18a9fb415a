"""The encoder as its users run it: GOPs of the synthetic RD clip, coded
frame by frame, back to back (a closed loop).

Per frame, through the port's library entry points: a K-frame (the GOP's
first, removal control) or a P-frame (adaptive control, warm-started from
the frame before) is fitted (`models.represent.init_train_state`,
`fit_frame`; a fit that overflows its intersection budget is fitted again
with twice its intersections, as the represent CLI does), its alive
splats become the representation (`drivers.represent.gmodel_from_state`),
QAT fits it (`models.compress.init_compress_state`, `fit_compress`, in
delta mode against the frame before for a P-frame), and the frame is
measured and coded (`measure_bits`, `compress.bitstream.encode_frame`).
The window holds whole frames, at least the first K- and P-frame: it
starts no other frame that the last frame's time says would end after
the window.

The check reads the window's first K-frame and first P-frame. Each runs
its represent fit and its QAT as chained slices, which are one fit to the
bit (the path of the CLIs' --fit_chunk): step 1 alone, then one slice to
step `check_steps`, whose steps after the first WARMUP are a graph
capture and its replays (`utils.graphs.StepGraph`), then the rest. Read
at steps 1 and `check_steps`: the losses, Adan's first moment after step
1 (the K-frame's), the parameters' change, and QAT's codebook. The
reference follows the same steps from the same inputs: the seeded start
of the K-frame, and, as the program handed them on, each frame's
representation into its QAT and the K-frame's into the P-frame's warm
start. Every coded frame of the window is read back with the reference's
codec and held to the codes of the fitted state it came from (the coder
alone).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.harness import faults, scenes, work
from benchmark.reference import codec, qat, splats


def _program():
    """The port's modules this loop drives (imported at first use)."""
    from gsvc_tpu_torch.compress import bitstream
    from gsvc_tpu_torch.config import FrameConfig
    from gsvc_tpu_torch.drivers import represent as rep_driver
    from gsvc_tpu_torch.models import compress, represent
    return bitstream, FrameConfig, rep_driver, compress, represent


# the checked frames: the window's first K-frame and first P-frame
CHECKED = 2

# the faults this loop's cells can have: planted on any device, and those
# that only a card's run reaches (the CPU runs every step eagerly)
FAULTS = [faults.state_unchanged, faults.half_the_batch, faults.coded_frame_altered]
CARD_FAULTS = [faults.replay_unchanged]
# the traffic's cut for the benchmark's CPU tests
TINY_TRAFFIC = {"warmup_iterations": 4, "warmup_qat_iterations": 4}


class State:
    """What set-up hands the window and the window hands the check."""


def _draws(seed: int, frame: int, stream: int) -> torch.Generator:
    """A host generator of one frame's random draws (init, revive, k-means)."""
    return scenes.generator(seed, 100 * frame + stream, "cpu")


def _uniforms(seed: int, frame: int, cap: int):
    g = _draws(seed, frame, 0)
    u = torch.rand((cap, 8), generator=g)
    return 2.0 * u[:, :2] - 1.0, u[:, 2:5], u[:, 5:8]


def frame_cfg(run, is_k: bool, num_points: int, max_intersects=None, iterations=None):
    _b, FrameConfig, _d, _c, _r = _program()
    c = run.config
    return FrameConfig(
        H=c["height"], W=c["width"], num_points=num_points,
        max_num_points=c["num_points"], iterations=iterations or c["iterations"],
        lr=c["lr"], loss_type=c["loss_type"], removal_rate=c["removal_rate"],
        densification_interval=c["densification_interval"],
        isremoval=is_k and c["is_rm"], isdensity=(not is_k) and c["is_ad"],
        backend=c["backend"], max_intersects=max_intersects)


def qat_cfg(run, n: int, iterations=None):
    _b, FrameConfig, _d, _c, _r = _program()
    c = run.config
    tb_x, tb_y = splats.grid(c["height"], c["width"])
    return FrameConfig(
        H=c["height"], W=c["width"], num_points=n, max_num_points=n,
        iterations=iterations or c["qat_iterations"], lr=c["lr"], loss_type=c["loss_type"],
        backend=c["backend"],
        max_intersects=splats.default_budget(n, tb_x * tb_y, c["compress_budget_factor"]))


def _clone(tree: dict) -> dict:
    return {k: v.detach().clone() for k, v in tree.items()}


def _splats_of(params, alive):
    """(NDC means, cholesky with bound, alive) clones of a fit's splats."""
    with torch.no_grad():
        return (torch.tanh(params.xyz).clone(), params.get_cholesky_elements.clone(),
                alive.clone())


class Frame:
    """The window's index-th frame: frame f (0-based) of the GOP, a K-frame
    where f is 0."""

    def __init__(self, run, index: int):
        self.f = index % run.traffic["gop"]
        self.is_k = self.f == 0


def _fit_represent(run, st, fr: Frame, iterations=None, record=None, traced=False):
    """The frame's represent fit; returns its final state."""
    _b, _F, rep_driver, _c, represent = _program()
    c = run.config
    n0 = c["num_points"] if fr.is_k else st.prev_count
    tb_x, tb_y = splats.grid(c["height"], c["width"])
    budget = (splats.default_budget(c["num_points"], tb_x * tb_y, c["represent_budget_factor"])
              if fr.is_k else st.budget)
    gt = st.clip[fr.f]
    sample = traced and run.traced  # a fit fitted again is not sampled twice
    sampled = False
    while True:
        cfg = frame_cfg(run, fr.is_k, n0, budget, iterations)
        warm = None if fr.is_k else rep_driver._warm_params(st.prev_gmodel, c["num_points"],
                                                             run.device)
        state = represent.init_train_state(
            cfg, warm=warm, warm_count=None if fr.is_k else n0,
            uniforms=_uniforms(run.seed, fr.f, c["num_points"]), device=run.device)
        draws = _draws(run.seed, fr.f, 1)
        if sample and not sampled:
            run.work["fit_ends"] = [_splats_of(state.params, state.alive)]
        if record is not None:
            record.update(budget=budget, count=n0,
                          start=_clone(represent._trainable(state.params)))
            state, record["steps"] = _check_slices(
                run, state, lambda s, lim: represent.fit_frame_partial(s, gt, lim, cfg,
                                                                       draws=draws),
                lambda s: {"loss": s.loss.clone(), "m": _clone(s.opt.exp_avg),
                           "leaves": _clone(represent._trainable(s.params))})
        if sample and not sampled:
            lo, hi = run.traffic["trace_steps"]
            state = represent.fit_frame_partial(state, gt, lo, cfg, draws=draws)
            run.work["slice_start"] = _splats_of(state.params, state.alive)
            with run.trace.sample():
                state = represent.fit_frame_partial(state, gt, hi, cfg, draws=draws)
            run.counters["traced_steps"] = hi - lo
            run.work["slice_end"] = _splats_of(state.params, state.alive)
            run.work["slice_budget"] = represent.intersection_budget(cfg)
            sampled = True
        res = represent.fit_frame(state, gt, cfg, draws=draws)
        overflow = int(res.state.max_overflow)
        if overflow == 0:
            break
        was = represent.intersection_budget(cfg)
        budget = -(-2 * (was + overflow) // 8192) * 8192
        run.counters["refits"] = run.counters.get("refits", 0) + 1
    if sampled:
        run.work["fit_ends"].append(_splats_of(res.state.params, res.state.alive))
        run.work["fit_budget"] = represent.intersection_budget(cfg)
    st.budget = budget
    return res.state


def _check_slices(run, state, fit_to, read):
    """A fit's steps 1 and 2 .. check_steps as two slices `fit_to(state,
    limit)` (the second runs WARMUP steps, then a graph capture and its
    replays): (the state after both, [read(state) after each])."""
    from gsvc_tpu_torch.utils import graphs

    state = fit_to(state, 1)
    first = read(state)
    replays = graphs.StepGraph.replays
    state = fit_to(state, run.traffic["check_steps"])
    run.counters["check_replays"] = (run.counters.get("check_replays", 0)
                                     + graphs.StepGraph.replays - replays)
    return state, [first, read(state)]


def _fit_qat(run, st, fr: Frame, gmodel, iterations=None, record=None):
    """QAT, bits and bytes of the frame: (blob, the fitted params on the host)."""
    bitstream, _F, _d, compress, _r = _program()
    n = gmodel["_xyz"].shape[0]
    cfg = qat_cfg(run, n, iterations)
    gt = st.clip[fr.f]
    cs = compress.init_compress_state(gmodel, None if fr.is_k else st.prev_gmodel, run.device)
    draws = _draws(run.seed, fr.f, 2)

    def leaves(s) -> dict:
        return _clone({f.name: getattr(s.params, f.name)
                       for f in dataclasses.fields(s.params)})

    if record is not None:
        record["qat_start"] = leaves(cs)
        cs, record["qat_steps"] = _check_slices(
            run, cs, lambda s, lim: compress.fit_compress(
                s, gt, dataclasses.replace(cfg, iterations=lim - s.it), reload_best=False,
                draws=draws),
            lambda s: {"loss": s.loss.clone(), "leaves": leaves(s),
                       "codebook": s.vq.embed.clone()})
    cs = compress.fit_compress(cs, gt, dataclasses.replace(cfg, iterations=cfg.iterations - cs.it),
                               draws=draws)
    _bits, _img = compress.measure_bits(cs, cfg)
    blob = bitstream.encode_frame(cs, cfg, "K" if fr.is_k else "P")
    p = cs.params
    host = {k: getattr(p, k).detach().cpu().numpy() for k in
            ("xyz", "cholesky", "features_dc", "q_scale", "q_beta")}
    host["embed"] = cs.vq.embed.detach().cpu().numpy()
    return blob, host


def code_frame(run, st, fr: Frame, record=None, traced=False, iterations=None,
               qat_iterations=None):
    _b, _F, rep_driver, _c, _r = _program()
    with run.spans("represent.traced" if traced and run.traced else "represent"):
        state = _fit_represent(run, st, fr, iterations, record, traced)
        gmodel = rep_driver.gmodel_from_state(state.params, state.alive)
    if record is not None:
        record.update(gmodel=gmodel, previous=st.prev_gmodel)
    with run.spans("qat"):
        blob, host = _fit_qat(run, st, fr, gmodel, qat_iterations, record)
    st.prev_gmodel, st.prev_count = gmodel, gmodel["_xyz"].shape[0]
    return blob, host


def setup(run) -> State:
    c, t = run.config, run.traffic
    st = State()
    st.clip = scenes.clip(run.seed, t["gop"], c["height"], c["width"], run.device)
    st.prev_gmodel, st.prev_count, st.budget = None, c["num_points"], None
    # load every kernel and host library and take the first graph captures:
    # a short K-frame and P-frame, each fitted, QAT-fitted, measured and coded
    for index in (0, 1):
        code_frame(run, st, Frame(run, index), iterations=t["warmup_iterations"],
                   qat_iterations=t["warmup_qat_iterations"])
    run.spans.seconds.clear()
    run.counters.clear()
    st.prev_gmodel, st.prev_count, st.budget = None, c["num_points"], None
    return st


def window(run, st: State) -> None:
    st.record, st.coded = [], []
    frames, total, last = 0, 0.0, 0.0
    while total + last <= run.seconds or frames < CHECKED:
        fr = Frame(run, frames)
        record = {} if frames < CHECKED else None
        t0 = time.perf_counter()
        blob, host = code_frame(run, st, fr, record=record,
                                traced=frames == run.traffic["trace_frame"])
        last = time.perf_counter() - t0
        total += last
        frames += 1
        st.coded.append((blob, host))
        if record is not None:
            st.record.append(record)
    run.attempted, run.failed = frames, 0
    run.e2e["encode_s_per_frame"] = total / frames
    run.counters["frames"] = frames


def trace_counts(run, st: State) -> None:
    """The benchmark's counts of the traced frame's work (after the window)."""
    if not run.traced or "slice_start" not in run.work:
        return
    c = run.config
    H, W = c["height"], c["width"]

    def counts(s, budget):
        return work.count(s[0], s[1], H, W, budget, s[2])

    sb = run.work["slice_budget"]
    run.work["slice"] = work.mean_counts(counts(run.work["slice_start"], sb),
                                         counts(run.work["slice_end"], sb))
    a, b = run.work["fit_ends"][0], run.work["fit_ends"][-1]
    fb = run.work["fit_budget"]
    run.work["step"] = work.mean_counts(counts(a, fb), counts(b, fb))


def free(st: State) -> None:
    """The fits' states went out of scope with their frames."""


def outputs(run, st: State) -> dict:
    """The program's readings of the window: the checked frames' steps and
    every coded frame read back."""
    b1 = 0.98
    frames = []
    for r in st.record:
        rep, q = r["steps"], r["qat_steps"]
        frames.append({
            "losses": [float(x["loss"]) for x in rep],
            "first_grads": {k: v.double() / (1 - b1) for k, v in rep[0]["m"].items()},
            "leaves": [r["start"]] + [x["leaves"] for x in rep],
            "qat_losses": [float(x["loss"]) for x in q],
            "qat_leaves": [r["qat_start"]] + [x["leaves"] for x in q],
            "codebooks": [x["codebook"] for x in q],
        })
    return {"frames": frames, "codes": [codec.read_frame(blob) for blob, _host in st.coded]}


def _represent_start(run, r: dict, f: int) -> tuple:
    """(init leaves, alive, revived) of checked frame f's fit: the K-frame's
    seeded splats, or the P-frame's warm start from the frame before's
    representation (the dead slots' seeded splats behind it) with the
    adaptive control's revive draws."""
    c, dev = run.config, run.device
    cap = c["num_points"]
    u_xyz, u_chol, u_feat = _uniforms(run.seed, f, cap)
    init = {"xyz": torch.atanh(torch.clamp(u_xyz, -1.0 + 1e-7, 1.0 - 1e-7)),
            "cholesky": u_chol, "features_dc": u_feat,
            "rgb_w": torch.full((cap, 1), 0.01 if f == 0 and c["is_rm"] else 1.0)}
    count = r["count"]
    revived = None
    if f > 0:
        prev = r["previous"]
        for k in ("xyz", "cholesky", "features_dc"):
            init[k][:count] = torch.as_tensor(np.asarray(prev[f"_{k}"][:count], np.float32))
        g = _draws(run.seed, f, 1)
        u = (2.0 * torch.rand((cap, 2), generator=g) - 1.0, torch.rand((cap, 3), generator=g),
             torch.rand((cap, 3), generator=g))
        revived = (tuple(x.to(dev) for x in u), int(cap * c["removal_rate"]))
    alive = torch.arange(cap, device=dev) < count
    return {k: v.to(dev) for k, v in init.items()}, alive, revived


def reference(run, st: State, dtype, control: bool = False) -> dict:
    """The reference's readings from the same inputs, in `dtype`; with
    `control`, the codes are the reference's own, worked out in `dtype`."""
    c = run.config
    dev = run.device
    tb_x, tb_y = splats.grid(c["height"], c["width"])
    steps = run.traffic["check_steps"]
    at = (0, steps - 1)  # the readings of steps 1 and check_steps
    frames = []
    for f, r in enumerate(st.record):
        init, alive, revived = _represent_start(run, r, f)
        fit = splats.represent_steps(init, alive, st.clip[f], r["budget"], steps, c["lr"],
                                     dtype, revived)
        n = r["gmodel"]["_xyz"].shape[0]
        g = _draws(run.seed, f, 2)
        picks = [torch.randperm(n, generator=g)[:qat.CODEBOOK].to(dev)
                 for _ in range(qat.STAGES)]
        qbudget = splats.default_budget(n, tb_x * tb_y, c["compress_budget_factor"])
        q = qat.qat_steps(r["gmodel"], r["previous"] if f else None, st.clip[f], qbudget,
                          picks, steps, c["lr"], dtype)
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


def _leaf_gap(prog: dict, ref: dict) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the larger of that leaf's reference norm and the median
    leaf's; leaves whose reference norm is under a thousandth of the
    median leaf's are left out (nought to rounding). Where the reference
    moved no leaf, 1 if the program moved one, else 0."""
    rn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref.items()}
    med = float(np.median(list(rn.values())))
    if med == 0.0:  # the reference moved no leaf: nor may the program
        return float(any(bool(torch.any(prog[k] != 0)) for k in ref))
    gaps = [abs(float(torch.linalg.vector_norm(prog[k].double())) - rn[k]) / max(rn[k], med)
            for k in ref if rn[k] >= 1e-3 * med]
    return max(gaps)


def _code_mismatch(got: list, want: list) -> float:
    """The share of coded values that differ, over every frame."""
    bad = total = 0
    for a, b in zip(got, want):
        for key in ("xyz16", "chol_codes", "indices", "q_scale", "q_beta", "embed"):
            x, y = np.asarray(a[key]), np.asarray(b[key])
            if x.shape != y.shape:
                bad += y.size
            else:
                bad += int(np.sum(x.astype(np.float64) != y.astype(np.float64)))
            total += y.size
    bad += abs(len(got) - len(want)) * (total // max(len(want), 1))
    return bad / max(total, 1)


def _codebook_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest entry's gap between two codebooks, against the
    reference codebook's largest entry."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


def _change_gap(got: list, want: list) -> float:
    """The worst leaf's change gap (`_leaf_gap`) over the two stretches
    of the checked steps: step 1 (a P-frame's revive), then steps 2 ..
    check_steps (the warm-up steps and the replays)."""
    def change(leaves, a, b):
        return {k: leaves[b][k].double() - leaves[a][k].double() for k in leaves[b]}

    return max(_leaf_gap(change(got, a, b), change(want, a, b)) for a, b in ((0, 1), (1, 2)))


def compare(prog: dict, ref: dict) -> dict:
    """Each number the worst over the checked frames (steps 1 and
    check_steps); the first gradient is the K-frame's (a P-frame's first
    step updates nothing)."""
    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    pairs = list(zip(prog["frames"], ref["frames"]))
    return {
        "rep_loss_gap": max(rel(p["losses"], r["losses"]) for p, r in pairs),
        "rep_grad_gap": _leaf_gap(pairs[0][0]["first_grads"], pairs[0][1]["first_grads"]),
        "rep_change_gap": max(_change_gap(p["leaves"], r["leaves"]) for p, r in pairs),
        "qat_loss_gap": max(rel(p["qat_losses"], r["qat_losses"]) for p, r in pairs),
        "qat_change_gap": max(_change_gap(p["qat_leaves"], r["qat_leaves"]) for p, r in pairs),
        "qat_codebook_gap": max(_codebook_gap(a, b) for p, r in pairs
                                for a, b in zip(p["codebooks"], r["codebooks"])),
        "code_mismatch": _code_mismatch(prog["codes"], ref["codes"]),
    }
