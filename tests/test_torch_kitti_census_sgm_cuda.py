"""SGM's constant P2 in every form of the CUDA kernels, and the KITTI
census + SGM chain on the card.

Marked ``cuda``: each test needs an NVIDIA GPU and nvcc and skips, with
its reason, where there is none.  On the card:

    python -m pytest tests/test_torch_kitti_census_sgm_cuda.py -q

* With ``adaptive_p2=False`` the serial form, the side-by-side form and
  the chunk kernel's carries, float32 and bf16, equal the plain version
  bit for bit, at the ring's edges and at KITTI's 375x1242, D = 128.
* ``StreamingEstimator`` with the KITTI options (a 9x7 census, P1 = 10,
  P2 = 120 constant) at 375x1242, D = 128 replays one CUDA graph whose
  SGM runs side by side and takes the argmin in its fold, and its
  disparities equal the plain reference
  (``portbench/reference/census_sgm.py``).
* A traced census stream stamps five times a frame, and its census codes'
  share of the cost stage lies inside it.

This file imports nothing of JAX.
"""

import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench.reference import census_sgm
from stereomatch_tpu_torch.io.capture import ImageSequenceCapture
from stereomatch_tpu_torch.ops import _build
from stereomatch_tpu_torch.ops import aggregation as agg_ops
from stereomatch_tpu_torch.ops import cost as cost_ops
from stereomatch_tpu_torch.ops import sgm_cuda
from stereomatch_tpu_torch.stream import StreamingEstimator

from .torch_shapes import CHUNK_SHORT_CASES

pytestmark = pytest.mark.cuda

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench"
                     / "configs" / "kitti-census-sgm.json").read_text())
KITTI = CONFIG["estimator"]
BF16 = torch.bfloat16

# The forms of semiglobal_aggregate_cuda, as test_torch_kernels_cuda.py
# names them.
FORMS = {"serial": sgm_cuda._aggregate_serial,
         "side_by_side": sgm_cuda._aggregate_side_by_side}
# (H, W, D): the ring's tails and short paths (D = 1, 37, 129; H = 1,
# W = 3), 16-byte copies (D = 128), and KITTI.
SHAPES = [(37, 53, 24), (9, 14, 1), (23, 31, 37), (17, 29, 129), (1, 40, 37),
          (30, 3, 129), (20, 26, 128), (375, 1242, 128)]


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


def _census(h, w, d, seed, device, dtype=torch.float32):
    """A 9x7 census volume of random 8-bit frames and its left image."""
    rng = np.random.default_rng(seed)
    left = torch.from_numpy(rng.integers(0, 256, (h, w))).to(device).float()
    right = torch.from_numpy(rng.integers(0, 256, (h, w))).to(device).float()
    vol = cost_ops.census_hamming_cost_volume(
        left, right, max_disparity=d, window_size=9, window_height=7,
        cost_dtype=dtype)
    return left, vol


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_constant_p2_forms_equal_the_plain_version(device, shape, form,
                                                   dtype):
    h, w, d = shape
    left, vol = _census(h, w, d, h + w + d, device, dtype)
    # Non-integer penalties too: P2' = max(P1, P2) is rounded as the plain
    # version rounds it.
    for p1, p2 in ((10.0, 120.0), (0.3, 7.7)):
        want = agg_ops.semiglobal_aggregate(vol, left, penalty1=p1,
                                            penalty2=p2, adaptive_p2=False)
        out = FORMS[form](vol, left, p1, p2, adaptive_p2=False)
        assert out.dtype == dtype and torch.equal(out, want), (p1, p2)
    adaptive = FORMS[form](vol, left, 10.0, 120.0)
    assert torch.equal(adaptive, agg_ops.semiglobal_aggregate(
        vol, left, penalty1=10.0, penalty2=120.0))


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,cuts", [((375, 1242, 128), (94, 188, 281)),
                                        ((37, 53, 24), (12,)),
                                        *[(s[:3], c)
                                          for s, c in CHUNK_SHORT_CASES]],
                         ids=["kitti", "ragged", "short-d1", "short-d37",
                              "short-d129"])
def test_constant_p2_chunks_carry_like_the_plain_version(device, shape, cuts,
                                                         dtype):
    h, w, d = shape
    left, vol = _census(h, w, d, 3 * h + w, device, dtype)
    edges = [0, *cuts, h]
    spans = list(zip(edges[:-1], edges[1:]))
    for step in agg_ops.TRAVERSALS[2:]:
        carry = (None, None)
        for rank, (a, b) in enumerate(spans if step[0] > 0 else spans[::-1]):
            kw = dict(penalty1=10.0, penalty2=120.0, seed=rank == 0,
                      adaptive_p2=False)
            ref, ref_carry = agg_ops.sweep_chunk_with_carry(
                vol[a:b], left[a:b], step, *carry, **kw)
            out, out_carry = sgm_cuda.sweep_chunk_with_carry_cuda(
                vol[a:b], left[a:b], step, *carry, **kw)
            assert torch.equal(out, ref), (step, a, b)
            assert torch.equal(out_carry[0], ref_carry[0]), (step, a, b)
            carry = ref_carry


def _kitti_frames(n, seed):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (n, 375, 1242), dtype=np.uint8)
    shifted = np.roll(left, -20, axis=2).astype(np.int64)
    right = np.clip(shifted + rng.integers(-2, 3, shifted.shape), 0, 255)
    return left, right.astype(np.uint8)


def test_the_kitti_stream_replays_one_graph_equal_to_the_reference(
        device, launches):
    left, right = _kitti_frames(2, 41)
    est = StreamingEstimator(128, batch=2, depth=1, **KITTI)
    frames = [np.concatenate([a, b], axis=1) for a, b in zip(left, right)]
    got = np.stack([d for _, d in est.run(ImageSequenceCapture(frames))])
    assert est._compiled is not None and len(est._compiled.graphs) == 1
    assert sgm_cuda._takes_side_by_side(375, 1242, 128)
    (graph,) = est._compiled.graphs.values()
    assert graph.launches["stm_sgm_side_by_side_f32"] == 1
    assert graph.launches["stm_sgm_fold_wta_f32"] == 1      # WTA in the fold
    assert graph.launches["stm_sgm_fold_f32"] == 0
    assert graph.launches["stm_sgm_rows_f32"] == 0
    assert est.stats.device_ops is not None      # replayed, not eager
    config = dict(CONFIG)
    with torch.no_grad():
        want = census_sgm.disparity(
            config, torch.from_numpy(left).to(device).float(),
            torch.from_numpy(right).to(device).float()).cpu().numpy()
    np.testing.assert_array_equal(got, want)


def test_a_traced_census_stream_stamps_five_times_a_frame(device):
    rng = np.random.default_rng(5)
    frames = [rng.integers(0, 256, (64, 256), dtype=np.uint8)
              for _ in range(4)]
    est = StreamingEstimator(32, batch=4, depth=1, **KITTI)
    list(est.run(ImageSequenceCapture(frames)))           # the plain graph
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        list(est.run(ImageSequenceCapture(frames)))
        torch.cuda.synchronize()
    st = est.stats
    assert st.frames_stamped == st.frames_run == 4
    assert st.stamps == 5 * 4
    (key,) = est._compiled.stamped
    assert est._compiled.stamped[key].stamps == 5
    stages = st.stage_device_s
    assert 0 < stages["census_codes"] < stages["cost"]
    assert all(stages[k] > 0 for k in ("cost", "aggregation", "reduce"))
