"""The census CUDA kernels (``csrc/census.cu``) against the plain PyTorch
census, on the card.

Marked ``cuda``: each test needs an NVIDIA GPU and nvcc and skips, with
its reason, where there is none.  On the card:

    python -m pytest --noconftest tests/test_torch_census_cuda.py -q

* The codes equal ``census_transform`` and the volume equals
  ``census_hamming_cost_volume``'s plain version bit for bit: windows of
  one to four code words (3x3, 5x5, 7x7, 9x7, 9x9, 11x11), float32, bf16
  and int32, D = 1, 61 (the scalar stores), 128 and 256, disparity
  offsets 0 and 17, W below D and off the block's 32 columns, zero and
  constant images, and KITTI's 375x1242 at D = 128.
* ``backend="auto"`` takes the kernels where ``census_cuda.fits`` holds
  and the plain version elsewhere (more words, a box sum); an explicit
  ``"cuda"`` raises there.
* A KITTI ``StreamingEstimator`` run launches both census entry points,
  once each in its graph's capture.

This file imports nothing of JAX.
"""

import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from stereomatch_tpu_torch.cost import Census
from stereomatch_tpu_torch.io.capture import ImageSequenceCapture
from stereomatch_tpu_torch.ops import _build, census_cuda
from stereomatch_tpu_torch.ops import cost as cost_ops
from stereomatch_tpu_torch.stream import StreamingEstimator

pytestmark = pytest.mark.cuda

KITTI = json.loads((Path(__file__).resolve().parents[1] / "portbench"
                    / "configs" / "kitti-census-sgm.json").read_text()
                   )["estimator"]
# (width, height): 1, 1, 2, 2, 3 and 4 code words.
WINDOWS = [(3, 3), (5, 5), (7, 7), (9, 7), (9, 9), (11, 11)]
DTYPES = [torch.float32, torch.bfloat16, torch.int32]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def launches(monkeypatch):
    counter = collections.Counter()
    monkeypatch.setattr(_build, "LAUNCHES", counter)
    return counter


def _pair(h, w, seed, device, levels=256):
    """Random images of ``levels`` integer levels (few levels: many ties
    between a neighbour and its centre)."""
    rng = np.random.default_rng(seed)
    left, right = (torch.from_numpy(rng.integers(0, levels, (h, w)))
                   .to(device).float() for _ in range(2))
    return left, right


def _plain(left, right, **kw):
    return cost_ops.census_hamming_cost_volume(left, right, backend="torch",
                                               **kw)


@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("shape", [(1, 1), (13, 45), (40, 67), (9, 300)],
                         ids=str)
def test_codes_equal_the_census_transform(device, launches, window, shape):
    for levels in (3, 256):
        left, right = _pair(*shape, sum(shape) + levels, device, levels)
        got = census_cuda.census_codes_cuda(left, right, *window)
        for image, codes in zip((left, right), got):
            want = cost_ops.census_transform(image, *window)
            assert codes.shape == want.shape and torch.equal(codes, want)
    assert launches["stm_census_codes"] == 2


@pytest.mark.parametrize("offset", [0, 17])
@pytest.mark.parametrize("d", [1, 61, 128, 256])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("window", WINDOWS, ids=str)
def test_volume_equals_the_plain_version(device, launches, window, dtype, d,
                                         offset):
    """W = 45 lies below D and off the block's 32 columns; W = 300 holds
    every disparity of the block."""
    kw = dict(max_disparity=d, window_size=window[0],
              window_height=window[1], cost_dtype=dtype,
              disparity_offset=offset)
    for h, w in ((11, 45), (5, 300)):
        left, right = _pair(h, w, h * w + d + offset, device, levels=4)
        got = cost_ops.census_hamming_cost_volume(left, right,
                                                  backend="cuda", **kw)
        want = _plain(left, right, **kw)
        assert got.dtype == dtype and torch.equal(got, want), (h, w)
    assert launches["stm_census_codes"] == 2
    assert launches[census_cuda._HAMMING[dtype]] == 2


@pytest.mark.parametrize("window", WINDOWS, ids=str)
@pytest.mark.parametrize("value", [0.0, 7.0])
def test_flat_images_cost_zero_where_valid(device, window, value):
    left = torch.full((17, 70), value, device=device)
    codes = census_cuda.census_codes_cuda(left, left, *window)
    # Inside, no neighbour is below the centre; at the edges the zero
    # padding is, where the centre is positive.
    assert torch.equal(codes[0], cost_ops.census_transform(left, *window))
    for dtype in DTYPES:
        kw = dict(max_disparity=37, window_size=window[0],
                  window_height=window[1], cost_dtype=dtype)
        got = cost_ops.census_hamming_cost_volume(left, left,
                                                  backend="cuda", **kw)
        assert torch.equal(got, _plain(left, left, **kw))


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kitti_volume_equals_the_plain_version(device, launches, dtype):
    left, right = _pair(375, 1242, 2025, device)
    kw = dict(max_disparity=128, window_size=9, window_height=7,
              cost_dtype=dtype)
    got = Census(128, 9, window_height=7, cost_volume_dtype=dtype)(left,
                                                                   right)
    assert torch.equal(got, _plain(left, right, **kw))
    assert launches["stm_census_codes"] == 1
    assert launches[census_cuda._HAMMING[dtype]] == 1


@pytest.mark.parametrize("window,kernel_size", [((13, 13), 1), ((9, 7), 3)],
                         ids=["six-words", "box-sum"])
def test_auto_serves_what_the_kernels_refuse_plainly(device, launches,
                                                     window, kernel_size):
    left, right = _pair(20, 50, 3, device)
    kw = dict(max_disparity=16, window_size=window[0],
              window_height=window[1], kernel_size=kernel_size)
    got = cost_ops.census_hamming_cost_volume(left, right, **kw)
    assert torch.equal(got, _plain(left, right, **kw))
    assert sum(launches.values()) == 0
    with pytest.raises(ValueError, match="census kernels"):
        cost_ops.census_hamming_cost_volume(left, right, backend="cuda",
                                            **kw)


def test_torch_backend_launches_nothing(device, launches):
    left, right = _pair(20, 50, 4, device)
    got = Census(16, 9, window_height=7, backend="torch")(left, right)
    assert sum(launches.values()) == 0
    assert torch.equal(got, Census(16, 9, window_height=7)(left, right))
    assert launches["stm_census_codes"] == 1


def test_the_kitti_stream_launches_both_census_kernels(device, launches):
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (375, 2 * 1242), dtype=np.uint8)
              for _ in range(2)]
    est = StreamingEstimator(128, batch=2, depth=1, **KITTI)
    disps = [d for _, d in est.run(ImageSequenceCapture(frames))]
    assert len(disps) == 2
    (graph,) = est._compiled.graphs.values()
    assert graph.launches["stm_census_codes"] == 1
    assert graph.launches["stm_census_hamming_f32"] == 1
    assert launches["stm_census_codes"] >= 1
    assert launches["stm_census_hamming_f32"] >= 1
