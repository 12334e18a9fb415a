"""The decode and eval renders as CUDA-graph replays
(gsvc_tpu_torch/utils/graphs.py `RenderGraph`, `RenderCache`;
compress/bitstream.decoded_renderer; decode.py), held to the eager renders.

On the CPU:
- the render cache keys on what fixes a render's shapes and code (frame
  size, splat count, budget, backend, layout, device; not the fit's other
  fields), holds at most 8 renders, evicts the least recently used first
  and closes what it evicts;
- the decoder's uint8 conversion on the device (`decode.to_uint8`) equals
  numpy's `(np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)` bit for
  bit, on seeded floats that include exact .5 boundaries after the float32
  multiply, values outside [0, 1], zeros of both signs and float32's
  extremes (no NaN);
- `decode.main` on the CPU, over a stream of K-frames of two splat counts,
  equals gsvc_tpu's decoder within one level (as test_decode_clis_agree),
  decodes the same with the numpy rANS, and keeps its stage seconds.

On a card (marker `cuda`, skipped without one; JAX is imported only inside
the CPU tests, so `python -m pytest --noconftest
tests/test_torch_graph_render.py -m cuda` runs where JAX is not
installed): the replayed decode render and the replayed eval render equal
the eager ones bitwise, also after new values are loaded; two splat counts
give two captures; a replay adds its capture's launch counts (K1, K2, and
K4 `image` or K5 with the eval render's epilogue, once each); the uint8
conversion on the card equals numpy's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gsvc_tpu_torch import decode
from gsvc_tpu_torch.compress import bitstream
from gsvc_tpu_torch.config import FrameConfig
from gsvc_tpu_torch.utils import graphs

H, W = 32, 48


def _cfg(n=40, **kw):
    return FrameConfig(H=H, W=W, num_points=n, max_num_points=n, iterations=1, **kw)


class _Fake:
    def __init__(self):
        self.closed = False

    def close(self):
        self.closed = True


def test_render_key_holds_what_fixes_shapes_and_code():
    base = graphs.render_key(_cfg(), 40, "image", "cpu")
    assert graphs.render_key(dataclasses.replace(_cfg(), iterations=7, lr=0.5), 40, "image",
                             "cpu") == base
    changed = [
        graphs.render_key(_cfg(), 41, "image", "cpu"),
        graphs.render_key(_cfg(max_intersects=8192), 40, "image", "cpu"),
        graphs.render_key(_cfg(backend="torch"), 40, "image", "cpu"),
        graphs.render_key(_cfg(), 40, "chw", "cpu"),
        graphs.render_key(dataclasses.replace(_cfg(), H=48), 40, "image", "cpu"),
        graphs.render_key(dataclasses.replace(_cfg(), W=32), 40, "image", "cpu"),
        graphs.render_key(_cfg(), 40, "image", "cuda:0"),
    ]
    assert len(set(changed)) == len(changed) and base not in changed


def test_render_cache_holds_eight_least_recently_used_first():
    cache = graphs.RenderCache()
    made = {}

    def make(k):
        made[k] = _Fake()
        return made[k]

    for k in range(8):
        cache.get(k, lambda k=k: make(k))
    assert cache.get(0, lambda: pytest.fail("a held render was made again")) is made[0]
    cache.get(8, lambda: make(8))  # evicts 1, the least recently used
    assert len(cache) == 8 and 1 not in cache and 0 in cache
    assert made[1].closed and not any(made[k].closed for k in (0, *range(2, 9)))
    for k in range(9, 20):
        cache.get(k, lambda k=k: make(k))
    assert len(cache) == 8 and sorted(k for k in made if not made[k].closed) == list(
        range(12, 20))


def test_cpu_renders_run_eagerly():
    assert not graphs.use_graph("cpu", None) and not graphs.use_graph("cpu", False)
    with pytest.raises(ValueError):
        graphs.use_graph("cpu", True)
    render = bitstream.decoded_renderer(40, _cfg(), "cpu")
    assert type(render) is graphs.EagerRender
    with graphs.eager():
        assert not graphs.use_graph("cuda", None)
    assert graphs.use_graph("cuda", None) and not graphs.use_graph("cuda", False)


def _splats(n, seed):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-0.9, 0.9, (n, 2)).astype(np.float32)
    chol = np.stack([rng.uniform(1.0, 3.0, n), rng.normal(0.0, 0.5, n),
                     rng.uniform(1.0, 3.0, n)], 1).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return means, chol, colors


def test_render_loads_values_into_its_inputs():
    render = bitstream.decoded_renderer(40, _cfg(), "cpu")
    a, b = _splats(40, 0), _splats(40, 1)
    render.load(*a)
    img_a = render().clone()
    render.load(*(torch.from_numpy(x) for x in b))
    img_b = render()
    assert torch.equal(img_a, bitstream.render_decoded(*a, _cfg()))
    assert torch.equal(img_b, bitstream.render_decoded(*b, _cfg()))
    assert not torch.equal(img_a, img_b)
    with pytest.raises(ValueError):
        render.load(*_splats(39, 2))


def _uint8_cases():
    """Seeded floats, many of which land exactly on k + 0.5 after the float32
    multiply by 255, with values outside [0, 1] and the extremes."""
    k = np.arange(255, dtype=np.float64)
    base = ((k + 0.5) / 255.0).astype(np.float32)
    near = [base]
    for _ in range(4):  # a few ulps either side of each boundary
        near += [np.nextafter(near[-1], np.float32(2.0)), np.nextafter(near[0], np.float32(-1))]
    near = np.concatenate(near)
    rng = np.random.default_rng(5)
    rand = rng.uniform(-0.5, 1.5, 20000).astype(np.float32)
    fine = (rng.integers(0, 255 * 64, 20000) / (255.0 * 64)).astype(np.float32)
    f32 = np.finfo(np.float32)
    extremes = np.array([0.0, -0.0, 1.0, f32.max, -f32.max, f32.tiny, -f32.tiny,
                         f32.smallest_subnormal, 1.0 - f32.epsneg, 1.0 + f32.eps,
                         0.5 / 255.0, 254.5 / 255.0], np.float32)
    x = np.concatenate([near, rand, fine, extremes]).astype(np.float32)
    with np.errstate(over="ignore", invalid="ignore"):  # the extremes overflow
        ties = (np.mod(x * np.float32(255.0), 1.0) == 0.5).sum()
    assert ties >= 100  # the test feeds ties
    return x


def _numpy_uint8(x):
    return (np.clip(x, 0.0, 1.0) * 255.0).round().astype(np.uint8)


def test_uint8_conversion_matches_numpy_bitwise():
    x = _uint8_cases()
    got = decode.to_uint8(torch.from_numpy(x)).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _numpy_uint8(x))


def _stream(tmp_path, counts):
    """K-frames of random splats, one a count, with pack_frame."""
    bs = tmp_path / "bitstream"
    bs.mkdir()
    for f, n in enumerate(counts, 1):
        means, chol, colors = _splats(n, seed=f)
        rng = np.random.default_rng(10 + f)
        scale = np.full(3, 4.0 / 63.0, np.float32)
        beta = np.array([0.5, -2.0, 0.5], np.float32)
        codes = rng.integers(0, 64, (n, 3))
        embed = rng.uniform(0.0, 0.5, (2, 8, 3)).astype(np.float32)
        idx = rng.integers(0, 8, (n, 2))
        blob = bitstream.pack_frame(np.arctanh(means).astype(np.float16), scale, beta,
                                    codes, embed, idx, "K")
        (bs / f"frame_{f}.gsvc").write_bytes(blob)
    k_file = tmp_path / "K_frames.txt"
    k_file.write_text("".join(f"{f}\n" for f in range(1, len(counts) + 1)))
    return bs, k_file


def test_decode_cli_on_cpu_matches_jax(tmp_path):
    import gsvc_tpu.decode as jdecode

    counts = (40, 40, 25)
    bs, k_file = _stream(tmp_path, counts)
    common = ["--bitstream", str(bs), "--height", str(H), "--width", str(W),
              "--k_frames", str(k_file), "--no_png"]
    assert jdecode.main(common + ["--out", str(tmp_path / "jax")]) == 0
    assert decode.main(common + ["--out", str(tmp_path / "port"), "--device", "cpu"]) == 0
    jrgb = np.fromfile(tmp_path / "jax" / "decoded.rgb", np.uint8)
    trgb = np.fromfile(tmp_path / "port" / "decoded.rgb", np.uint8)
    assert trgb.size == jrgb.size == len(counts) * H * W * 3
    assert np.abs(trgb.astype(int) - jrgb.astype(int)).max() <= 1
    assert decode.STAGES["frames"] == len(counts)
    assert all(decode.STAGES[k] > 0 for k in ("entropy", "unpack", "render", "d2h",
                                               "write"))
    for f in range(1, len(counts) + 1):
        blob = (bs / f"frame_{f}.gsvc").read_bytes()
        for a, b in zip(bitstream.decode_frame(blob),
                        bitstream.decode_frame(blob, native=False)):
            np.testing.assert_array_equal(a, b)


# -- on the card -----------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernels run only on the card")
    return torch.device("cuda")


CARD = dict(H=256, W=256)


def _card_cfg(n, backend="auto"):
    return FrameConfig(**CARD, num_points=n, max_num_points=n, iterations=1, backend=backend,
                       max_intersects=16384)


def _launches():
    return graphs.launch_counts()


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


@pytest.mark.cuda
def test_decode_render_replay_equals_eager(dev):
    captures = graphs.RenderGraph.captures
    for n in (300, 200):
        cfg = _card_cfg(n)
        for seed in range(3):
            frame = _splats(n, seed)
            want = bitstream.render_decoded(*frame, cfg, dev, graph=False).clone()
            before = _launches()
            got = bitstream.render_decoded(*frame, cfg, dev)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (n, seed)
            assert _delta(_launches(), before) == {
                "fill_decode_keys": 1, "rank_cap_decode": 1, "forward_image_clipped": 1}
    assert graphs.RenderGraph.captures - captures == 2
    render = bitstream.decoded_renderer(300, _card_cfg(300), dev)
    assert isinstance(render, graphs.RenderGraph)
    added = dict(render.added)  # what each replay adds to the recorder's counters
    keys = added.get("binning.keys", 0)
    assert keys > 0 and added == {
        "launches.fill_decode_keys": 1, "launches.rank_cap_decode": 1,
        "launches.forward_image_clipped": 1, "binning.keys": keys, "binning.key_bytes": 4 * keys}


@pytest.mark.cuda
def test_eval_render_replay_equals_eager(dev):
    from gsvc_tpu_torch.core import init_splats
    from gsvc_tpu_torch.models.represent import render_frame

    cfg = _card_cfg(400)
    params, alive = init_splats(400, generator=torch.Generator().manual_seed(0), device=dev)
    alive[::7] = False
    with graphs.render_graph(lambda: render_frame(params, alive, cfg, layout="chw"), (),
                             dev) as render:
        first = render().clone()
        replays = graphs.RenderGraph.replays
        before = _launches()
        again = render()
        torch.cuda.synchronize()
        assert graphs.RenderGraph.replays == replays + 1
        assert _delta(_launches(), before) == {
            "fill_decode_keys": 1, "rank_cap_decode": 1, "forward_chw_clipped": 1}
        assert torch.equal(again, first)
        with torch.no_grad():  # the graph reads the state's own tensors
            params.xyz.mul_(0.5)
        moved = render()
        assert not torch.equal(moved, first)
        assert torch.equal(moved, render_frame(params, alive, cfg, layout="chw"))


@pytest.mark.cuda
def test_uint8_conversion_on_the_card_matches_numpy(dev):
    x = _uint8_cases()
    got = decode.to_uint8(torch.from_numpy(x).to(dev)).cpu().numpy()
    np.testing.assert_array_equal(got, _numpy_uint8(x))
