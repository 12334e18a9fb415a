"""The port's native host code (gsvc_tpu_torch/native: rANS and I420,
built with g++ at first use by gsvc_tpu_torch/_build.py) against gsvc_tpu.

- rANS: for every length and alphabet size below (one symbol up to 64),
  the port's native encode writes gsvc_tpu's words, both those of its
  numpy `_encode` and of its `compress_matrix_flatten_categorical`; the
  port's plain numpy codec (native=False) writes the same; both decode
  paths give the message back; a stream of fewer than two words and a pmf
  that does not sum to 2^16 raise. Exact equality throughout.
- I420: the port's `yuv420_to_rgb`, native and plain, equals gsvc_tpu's
  (cv2 where it is installed, else its own native yuv.cpp) bit for bit on
  seeded random frames of two even sizes, with full-range and video-range
  values, and so does `process_yuv_video` of a written file.
- the build: the libraries land in gsvc_tpu_torch/build/, and a source
  that does not compile raises with g++'s output.
"""

import numpy as np
import pytest

from gsvc_tpu.compress import entropy as jentropy
from gsvc_tpu.io import yuv as jyuv
from gsvc_tpu_torch import _build
from gsvc_tpu_torch.compress import entropy
from gsvc_tpu_torch.io import yuv

CODEC_CASES = [(1, 1), (500, 1), (3, 64), (257, 2), (5000, 17), (20000, 64)]


def _message(n, k, seed):
    """n symbols over k values, skewed so the pmf is far from uniform."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.05, 1.0, k) ** 3
    return rng.choice(k, size=n, p=p / p.sum()).astype(np.int32) * 3 - 7


@pytest.mark.parametrize("n,k", CODEC_CASES)
def test_rans_words_match_jax(n, k):
    m = _message(n, k, seed=n + k)
    words, counts, unique = entropy.compress_matrix_flatten_categorical(m)
    jwords, jcounts, junique = jentropy.compress_matrix_flatten_categorical(m)
    np.testing.assert_array_equal(words, jwords)
    np.testing.assert_array_equal(counts, jcounts)
    np.testing.assert_array_equal(unique, junique)
    assert unique.dtype == junique.dtype and words.dtype == np.uint32
    _values, inverse = np.unique(m, return_inverse=True)
    pmf = jentropy._quantize_pmf(jcounts)
    np.testing.assert_array_equal(entropy._quantize_pmf(counts), pmf)
    np.testing.assert_array_equal(words, jentropy._encode(inverse.astype(np.int32), pmf))
    plain, _c, _u = entropy.compress_matrix_flatten_categorical(m, native=False)
    np.testing.assert_array_equal(plain, words)


@pytest.mark.parametrize("n,k", CODEC_CASES)
def test_rans_decode_round_trips(n, k):
    m = _message(n, k, seed=2 * n + k).reshape(-1, 1)
    words, counts, unique = entropy.compress_matrix_flatten_categorical(m)
    for native in (True, False):
        got = entropy.decompress_matrix_flatten_categorical(
            words, counts, unique, n, (n, 1), native=native)
        np.testing.assert_array_equal(got, m)
    jgot = jentropy.decompress_matrix_flatten_categorical(words, counts, unique, n, (n, 1))
    np.testing.assert_array_equal(jgot, m)


def test_rans_malformed_streams_raise():
    m = _message(1000, 9, seed=3)
    words, counts, unique = entropy.compress_matrix_flatten_categorical(m)
    for cut in (words[:1], words[:0]):
        with pytest.raises(ValueError, match="fewer than 2 words"):
            entropy.decompress_matrix_flatten_categorical(cut, counts, unique, m.size,
                                                          m.shape)
    pmf = entropy._quantize_pmf(counts)
    pmf[0] += 1
    with pytest.raises(ValueError, match="2\\^16"):
        entropy._decode_native(words, pmf, m.size)


def test_native_libraries_build_into_the_package(tmp_path, monkeypatch):
    from gsvc_tpu_torch.native import rans_lib, yuv_lib

    rans_lib(), yuv_lib()
    for name in ("rans", "yuv"):
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.is_file()
    # a source that does not compile raises, with g++'s message
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_build, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for .*broken.cpp"):
        _build.load("broken")
    assert not list((tmp_path / "build").glob("*.so"))


def _i420(width, height, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, (height * 3 // 2, width), dtype=np.uint8)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("lo,hi", [(0, 256), (16, 236)])
@pytest.mark.parametrize("width,height", [(1920, 1080), (62, 34)])
def test_yuv420_to_rgb_matches_jax_bitwise(width, height, lo, hi, native):
    frame = _i420(width, height, lo, hi, seed=width + lo)
    want = jyuv.yuv420_to_rgb(frame, width, height)
    got = yuv.yuv420_to_rgb(frame, width, height, native=native)
    assert got.dtype == np.uint8 and got.shape == (height, width, 3)
    np.testing.assert_array_equal(got, want)


def test_process_yuv_video_matches_jax(tmp_path):
    width, height = 96, 64
    path = tmp_path / "v.yuv"
    np.concatenate([_i420(width, height, 0, 256, seed=s) for s in range(3)]).tofile(path)
    got = yuv.process_yuv_video(str(path), width, height)
    want = jyuv.process_yuv_video(str(path), width, height)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert len(yuv.process_yuv_video(str(path), width, height, limit=2)) == 2
