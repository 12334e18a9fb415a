"""The benchmark's blocked reference (`benchmark/reference/splats_blocked.py`,
`qat_blocked.py`) against the one it copies (`splats.py`, `qat.py`), in
float64 at a small size with chunks of a few pairs, so that the render
runs in many chunks: the image, the L2 loss and its gradients, 3
represent steps (a K-frame, and a P-frame whose step 1 revives) and 3 QAT
steps (a K-frame and a delta-mode P-frame).

Tolerance 1e-12 of the largest entry: the forward is the same code; the
blocked backward sums each chunk's gradient in chunk order where
autograd sums them in its own, so the two differ by float64 rounding
alone (~1e-16 of an entry, a few hundred ulp at the most over 3 steps).
"""

from __future__ import annotations

import pytest
import torch

from benchmark.reference import qat, qat_blocked, splats, splats_blocked

H, W, N = 40, 56, 70
TOL = 1e-12


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    """Chunks of 3 pairs (~20 chunks a render)."""
    monkeypatch.setattr(splats, "CHUNK_VALUES", 3 * splats.BLOCK * splats.BLOCK)


def _close(got, want) -> None:
    got, want = torch.as_tensor(got, dtype=torch.float64), torch.as_tensor(
        want, dtype=torch.float64)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= TOL * max(scale, 1e-300), (got, want)


def _splats(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"xyz": torch.atanh(1.8 * torch.rand((N, 2), generator=g, dtype=torch.float64)
                               - 0.9),
            "cholesky": 2.0 * torch.rand((N, 3), generator=g, dtype=torch.float64),
            "features_dc": torch.rand((N, 3), generator=g, dtype=torch.float64),
            "rgb_w": torch.ones((N, 1), dtype=torch.float64)}


def _gt() -> torch.Tensor:
    return torch.rand((H, W, 3), generator=torch.Generator().manual_seed(9),
                      dtype=torch.float64)


def _budget() -> int:
    return splats.default_budget(N, splats.grid(H, W)[0] * splats.grid(H, W)[1])


def test_render_loss_and_gradients_equal_the_unblocked():
    p = _splats(1)
    alive = torch.arange(N) % 7 != 3
    out = []
    for mod in (splats, splats_blocked):
        leaves = [t.clone().requires_grad_() for t in (p["xyz"], p["cholesky"],
                                                       p["features_dc"])]
        img = mod.render_splats(torch.tanh(leaves[0]), leaves[1] + splats.bound(leaves[1]),
                                leaves[2], H, W, _budget(), alive)
        loss = torch.sum((img - _gt()) ** 2) / (H * W * 3)
        out.append((img.detach(), loss.detach(), torch.autograd.grad(loss, leaves)))
    pairs = splats.bin_pairs(splats.project(torch.tanh(p["xyz"]),
                                            p["cholesky"] + splats.bound(p["cholesky"]),
                                            H, W, alive), H, W, _budget())
    assert pairs.tile.shape[0] > 10 * 3  # many chunks
    (img, loss, grads), (bimg, bloss, bgrads) = out
    assert torch.equal(img, bimg)  # the same forward
    _close(bloss, loss)
    for a, b in zip(bgrads, grads):
        _close(a, b)


@pytest.mark.parametrize("frame", ["K", "P"])
def test_represent_steps_equal_the_unblocked(frame):
    init = _splats(2)
    alive = torch.arange(N) < N - 10
    revived = None
    if frame == "P":
        g = torch.Generator().manual_seed(4)
        revived = ((2.0 * torch.rand((N, 2), generator=g) - 1.0, torch.rand((N, 3), generator=g),
                    torch.rand((N, 3), generator=g)), 6)
    runs = [mod.represent_steps({k: v.clone() for k, v in init.items()}, alive, _gt(),
                                _budget(), 3, 1e-2, torch.float64, revived)
            for mod in (splats, splats_blocked)]
    want, got = runs
    _close(got.losses, want.losses)
    for k in want.first_grads:
        _close(got.first_grads[k], want.first_grads[k])
    for a, b in zip(got.after, want.after):
        for k in b:
            _close(a[k], b[k])


@pytest.mark.parametrize("delta", [False, True])
def test_qat_steps_equal_the_unblocked(delta):
    def gmodel(seed):
        p = _splats(seed)
        return {f"_{k}": p[k].float().numpy() for k in ("xyz", "cholesky", "features_dc")}

    cur, prev = gmodel(5), gmodel(6) if delta else None
    g = torch.Generator().manual_seed(8)
    picks = [torch.randperm(N, generator=g)[:qat.CODEBOOK] for _ in range(qat.STAGES)]
    runs = [mod.qat_steps(cur, prev, _gt(), _budget(), picks, 3, 1e-2, torch.float64)
            for mod in (qat, qat_blocked)]
    want, got = runs
    _close(got.losses, want.losses)
    for a, b in zip(got.after, want.after):
        for k in b:
            _close(a[k], b[k])
    for a, b in zip(got.embeds, want.embeds):
        _close(a, b)
