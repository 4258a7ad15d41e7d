"""The port's rectangular census windows and SGM's constant P2 against
the plain reference of the KITTI census + SGM cell
(``portbench/reference/census_sgm.py``), on the CPU.

Seeded random 8-bit frames of 24x48 at D = 16.  Census codes and
Hamming counts are integers, and with integer penalties every SGM path
cost and sum is an integer below 2^24, so every comparison is equality:

* the codes of 9x7, 7x9, 3x5 and square windows, word for word the
  reference's int64 code, and a square window bit-equal to the code of
  the window given by its width alone;
* the Hamming volume, +inf wedge included;
* ``Semiglobal(adaptive_p2=False)`` on the plain path, and the
  adaptive P2 unchanged;
* ``create_pipeline`` and ``StreamingEstimator`` with the KITTI options,
  disparity for disparity;
* the row-sharded and 2-D tiled meshes, whose census halos are half
  the window's height, against one device;
* the refusals of the pyramid, the temporal tracker and their CLIs;
* the stage stamps' parser with the census codes' stamp, and the
  census spans on a profiler's timeline.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.reference import census_sgm, stereo
from stereomatch_tpu_torch import cli_common
from stereomatch_tpu_torch.aggregation import Semiglobal
from stereomatch_tpu_torch.cost import Census
from stereomatch_tpu_torch.ops import cost as cost_ops
from stereomatch_tpu_torch.parallel import (make_mesh, make_mesh_2d,
                                            make_sharded_estimate,
                                            make_tiled2d_estimate)
from stereomatch_tpu_torch.stream import StreamingEstimator
from stereomatch_tpu_torch.utils import profiling

H, W, D = 24, 48, 16
CPU = torch.device("cpu")
CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench"
                     / "configs" / "kitti-census-sgm.json").read_text())
KITTI = CONFIG["estimator"]                 # 9x7 census, constant P2
WINDOWS = [(9, 7), (7, 9), (3, 5), (3, 3), (5, 5), (7, 7)]


def _frames(n, seed):
    """``n`` 8-bit pairs [n, H, W] as float32: the right view the left
    shifted by 3 columns, with 2 levels of noise."""
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (n, H, W))
    right = np.clip(np.roll(left, -3, axis=2)
                    + rng.integers(-2, 3, left.shape), 0, 255)
    return (torch.from_numpy(left).to(torch.float32),
            torch.from_numpy(right).to(torch.float32))


def _as_int64(words):
    """The int64 code of the port's int32 code words."""
    if words.ndim == 2:
        words = words[..., None]
    return sum((words[..., k].to(torch.int64) & 0xFFFFFFFF) << (32 * k)
               for k in range(words.shape[-1]))


def _reference(estimator, left, right, **sgm):
    config = dict(CONFIG, height=H, width=W, max_disparity=D,
                  estimator=estimator)
    return census_sgm.disparity(config, left, right, **sgm)


@pytest.mark.parametrize("width,height", WINDOWS, ids=str)
def test_census_codes_equal_the_reference(width, height):
    left, _ = _frames(1, width * 10 + height)
    left[0, 5:9, 4:12] = 77.0                # plateaus: ties set no bit
    code = cost_ops.census_transform(left[0], width, height)
    assert code.dtype == torch.int32
    assert code.ndim == (2 if width * height - 1 <= 32 else 3)
    assert torch.equal(_as_int64(code),
                       census_sgm.census_codes(left[0], width, height))
    if width == height:
        assert torch.equal(code, cost_ops.census_transform(left[0], width))


@pytest.mark.parametrize("width,height", WINDOWS, ids=str)
def test_hamming_volume_equals_the_reference(width, height):
    left, right = _frames(1, width + 3 * height)
    vol = cost_ops.census_hamming_cost_volume(
        left[0], right[0], max_disparity=D, window_size=width,
        window_height=height)
    want = census_sgm.census_volume(left, right, D, width, height)[0]
    assert torch.equal(vol, want)
    assert torch.equal(Census(D, window_size=width,
                              window_height=height)(left[0], right[0]), want)


def test_census_refuses_an_even_or_empty_height():
    with pytest.raises(ValueError, match="odd"):
        cost_ops.census_transform(torch.zeros(6, 6), 5, 4)
    with pytest.raises(ValueError, match="positive"):
        Census(D, window_size=9, window_height=0)


@pytest.mark.parametrize("adaptive", [False, True], ids=["constant",
                                                         "adaptive"])
def test_semiglobal_equals_the_reference(adaptive):
    left, right = _frames(1, 5)
    vol = census_sgm.census_volume(left, right, D, 9, 7)
    out = Semiglobal(10.0, 120.0, adaptive_p2=adaptive, backend="torch")(
        vol[0], left[0])
    want = stereo.semiglobal(vol, left, 10.0, 120.0, adaptive=adaptive)[0]
    assert torch.equal(out, want)
    if not adaptive:
        assert not torch.equal(out, Semiglobal(10.0, 120.0,
                                               backend="torch")(vol[0],
                                                                left[0]))


def test_the_pipeline_and_the_stream_equal_the_reference():
    left, right = _frames(3, 11)
    want = _reference(KITTI, left, right)
    pipe = cli_common.create_pipeline(
        "census", "wta", "sgm", max_disparity=D, penalty1=10, penalty2=120,
        census_window=9, census_height=7, adaptive_p2=False, device="cpu")
    for i in range(3):
        assert torch.equal(pipe.estimate(left[i], right[i]), want[i])
    est = StreamingEstimator(D, batch=3, device="cpu", **KITTI)
    got = est.estimate_batch(left.to(torch.uint8), right.to(torch.uint8))
    assert torch.equal(got, want)
    # Each option moves the answer: neither is dropped on the way.
    for change in ({"census_height": 9}, {"adaptive_p2": True}):
        moved = StreamingEstimator(D, batch=3, device="cpu",
                                   **dict(KITTI, **change))
        assert not torch.equal(moved.estimate_batch(left, right), want)


@pytest.mark.parametrize("mode", ["exact", "overlap"])
def test_row_sharded_mesh_equals_one_device(mode):
    left, right = _frames(2, 21)
    want = _reference(KITTI, left, right)
    fn = make_sharded_estimate(
        make_mesh([CPU] * 4, n_batch=1), max_disparity=D, cost="census",
        census_window=9, census_height=7, adaptive_p2=False, penalty1=10,
        penalty2=120, sgm_mode=mode, overlap=H)
    assert torch.equal(fn(left, right), want)
    est = StreamingEstimator(D, batch=2, mesh=make_mesh([CPU] * 4,
                                                        n_batch=1), **KITTI)
    assert torch.equal(est.estimate_batch(left, right).cpu(), want)


def test_2d_tiles_equal_one_device():
    left, right = _frames(2, 23)
    want = _reference(KITTI, left, right)
    fn = make_tiled2d_estimate(
        make_mesh_2d([CPU] * 4, 1, 2, 2), max_disparity=D, cost="census",
        census_window=9, census_height=7, adaptive_p2=False, penalty1=10,
        penalty2=120)
    assert torch.equal(fn(left, right), want)


@pytest.mark.parametrize("option", [{"census_height": 7},
                                    {"adaptive_p2": False}], ids=str)
def test_the_pyramid_refuses_a_rectangle_and_the_constant_p2(option):
    with pytest.raises(ValueError, match="pyramid_levels"):
        StreamingEstimator(D, pyramid_levels=1, device="cpu", **option)


@pytest.mark.parametrize("cli,argv", [
    ("image", ["l.png", "r.png", "16", "o.png", "--pyramid", "1",
               "--census-height", "7"]),
    ("video", ["y4m", "in.y4m", "16", "--temporal", "--constant-p2"]),
    ("video", ["y4m", "in.y4m", "16", "--pyramid", "1", "--census-height",
               "3"]),
    ("serve", ["16", "--pyramid", "1", "--constant-p2"]),
    ("evaluate", ["--synthetic", "1", "--configs", "pyramid1",
                  "--census-height", "7", "--device", "cpu"]),
    ("evaluate", ["--synthetic", "1", "--tune", "1", "--constant-p2",
                  "--device", "cpu"])], ids=str)
def test_the_clis_refuse_them_beside_a_square_census(cli, argv, capsys):
    import importlib
    main = importlib.import_module(f"stereomatch_tpu_torch.cli.{cli}").main
    assert main(argv) == 2
    assert "incompatible with --" in capsys.readouterr().err


def _records(frames):
    """Stamp rows {slot, time ns, frame, stage id} of ``frames``, each a
    BEGIN time and its (stage id, time) stamps."""
    rows, slot = [], 0
    for number, (begin, stamps) in enumerate(frames, start=1):
        for stage_id, t in [(profiling.BEGIN, begin)] + stamps:
            rows.append((slot, t, number, stage_id))
            slot += 1
    return np.array(rows, dtype=np.uint64).reshape(-1, 4)


def test_stage_seconds_read_the_census_codes_stamp():
    codes = profiling.POINT_IDS["census_codes"]
    rows = _records([(1000, [(codes, 1300), (1, 2000), (2, 2500), (3, 2600)]),
                     (5000, [(codes, 5100), (1, 5400), (2, 6000),
                             (3, 6050)])])
    seconds, frames = profiling.stage_seconds(rows)
    assert frames == 2
    assert seconds["census_codes"] == pytest.approx((300 + 100) * 1e-9)
    assert seconds["cost"] == pytest.approx((1000 + 400) * 1e-9)
    assert seconds["aggregation"] == pytest.approx((500 + 600) * 1e-9)
    assert seconds["reduce"] == pytest.approx((100 + 50) * 1e-9)
    # A frame without the stamp has no "census_codes" key.
    plain = _records([(0, [(1, 40), (2, 90), (3, 100)])])
    assert "census_codes" not in profiling.stage_seconds(plain)[0]


def test_the_census_spans_are_on_the_profilers_timeline():
    left, right = _frames(1, 3)
    census = Census(D, window_size=9, window_height=7)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        census(left[0], right[0])
    names = {e.name for e in prof.events()}
    assert {"stm/cost/census_codes", "stm/cost/census_hamming"} <= names
