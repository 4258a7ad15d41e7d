"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Marked ``cuda``: each test needs an NVIDIA GPU and nvcc and skips, with
its reason, where there is none.  On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q

The SSD (at the edges of its tile: short and ragged H and W, odd D, k
from 1 to 150, streamed rows, the int32 chain, SAD, a refused k), SGM
(the ring's tails and short paths, the chunk kernel's carries, chunks
shorter than the ring and out views included) and DP kernels keep their
plain versions' association and round every operation on its own, so
those comparisons are bit-equality.  The CVF kernels keep the plain version's association too
and are held equal to it, +inf placement included, at the edges of their
tile (narrow and ragged W, H shorter than the window or than a row
chunk, odd D, radii 0 to 32, a wedge offset, a misaligned volume).  The
stream and ``stm-serve`` are held at teddy against the eager pipeline:
the pinned staging ring refilled under depth 3, one graph a geometry
replayed by concurrent server batches.  This file imports nothing of
JAX, so it runs where JAX is not installed.
"""

import collections
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from stereomatch_tpu_torch import cli_common
from stereomatch_tpu_torch.io.synthetic import stereo_pair
from stereomatch_tpu_torch.ops import aggregation as agg_ops
from stereomatch_tpu_torch.ops import cost as cost_ops
from stereomatch_tpu_torch.ops import cvf as cvf_ops
from stereomatch_tpu_torch.ops import disparity as disp_ops
from stereomatch_tpu_torch.ops import (_build, cvf_cuda, dp_cuda, sgm_cuda,
                                       ssd_cuda)
from stereomatch_tpu_torch.parallel import ShardedPipeline, make_mesh

from .torch_shapes import (CHUNK_SHORT_CASES, DP_RAMP_CASES, SSD_EDGE_SHAPES,
                           SSD_INT_SHAPE, SSD_REFUSED_K, ramp_cost_volume)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture
def launches(monkeypatch):
    """The launch counts of every C entry point, from 0."""
    counter = collections.Counter()
    monkeypatch.setattr(_build, "LAUNCHES", counter)
    return counter


def _images(h, w, seed, device):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((h, w), np.float32)).to(device),
            torch.from_numpy(rng.random((h, w), np.float32)).to(device))


SHAPES = [(37, 53, 24, 3), (5, 12, 16, 7), (1, 10, 4, 2), (64, 96, 40, 5),
          (20, 31, 300, 2)]


@pytest.mark.parametrize("absolute", [False, True], ids=["ssd", "sad"])
@pytest.mark.parametrize("shape", SHAPES + SSD_EDGE_SHAPES, ids=str)
def test_ssd_kernel_bit_equal(device, shape, absolute):
    h, w, d, k = shape
    left, right = _images(h, w, h + w, device)
    kw = dict(max_disparity=d, kernel_size=k)
    ref = cost_ops._diff_cost_volume(left, right, cost_dtype=torch.float32,
                                     absolute=absolute, **kw)
    out = ssd_cuda.diff_cost_volume_cuda(left, right,
                                         cost_dtype=torch.float32,
                                         absolute=absolute, **kw)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("absolute", [False, True], ids=["ssd", "sad"])
@pytest.mark.parametrize("in_dtype,shape", [
    (torch.uint8, (21, 33, 16, 5)), (torch.int16, (21, 33, 16, 5)),
    (torch.uint8, SSD_INT_SHAPE)], ids=str)
def test_ssd_kernel_int32_chain_exact(device, in_dtype, shape, absolute):
    h, w, d, k = shape
    left, right = _images(h, w, 3, device)
    scale = 255 if in_dtype == torch.uint8 else 30000
    left8, right8 = (left * scale).to(in_dtype), (right * scale).to(in_dtype)
    kw = dict(max_disparity=d, kernel_size=k, cost_dtype=torch.int32)
    ref = cost_ops._diff_cost_volume(left8, right8, absolute=absolute, **kw)
    out = ssd_cuda.diff_cost_volume_cuda(left8, right8, absolute=absolute,
                                         **kw)
    assert torch.equal(out, ref)


def test_ssd_kernel_refuses_a_k_past_shared_memory(device, launches):
    left, right = _images(4, 8, 1, device)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_cuda.diff_cost_volume_cuda(
            left, right, max_disparity=4, kernel_size=SSD_REFUSED_K,
            cost_dtype=torch.float32, absolute=False)
    assert sum(launches.values()) == 0


# The SGM ring's edges beside SHAPES: D % 4 != 0 with lanes past D
# (D = 1, 37, 129: VPL 1, 2 and 8, 4-byte copies), paths shorter than
# the ring (H = 1, W = 3) and 16-byte copies (D = 128).
SGM_SHAPES = SHAPES + [(9, 14, 1, 2), (23, 31, 37, 3), (17, 29, 129, 2),
                       (1, 40, 37, 3), (30, 3, 129, 2), (1, 3, 64, 1),
                       (12, 3, 40, 2), (20, 26, 128, 3)]


# The two forms of semiglobal_aggregate_cuda: eight launches in TRAVERSALS
# order, or seven traversals side by side and the last folding their sum.
SGM_FORMS = {"serial": sgm_cuda._aggregate_serial,
             "side_by_side": sgm_cuda._aggregate_side_by_side}


def _sgm_launches(launches, sfx="f32"):
    """The launches of the whole-image SGM entry points."""
    return {name: launches[f"stm_sgm_{name}_{sfx}"]
            for name in ("rows", "horizontal", "side_by_side", "fold")}


def _sgm_counts(shape, frames=1):
    """What :func:`_sgm_launches` reads after ``frames`` aggregations of
    [H, W, D] ``shape``: the form the rule picks there."""
    if sgm_cuda._takes_side_by_side(*shape):
        return dict(rows=0, horizontal=0, side_by_side=frames, fold=frames)
    return dict(rows=6 * frames, horizontal=2 * frames, side_by_side=0,
                fold=0)


@pytest.mark.parametrize("form", SGM_FORMS)
@pytest.mark.parametrize("shape", SGM_SHAPES, ids=str)
def test_sgm_kernels_bit_equal(device, shape, form):
    h, w, d, k = shape
    left, right = _images(h, w, 2 * h + w, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=d,
                                   kernel_size=k)
    ref = agg_ops.semiglobal_aggregate(vol, left, penalty1=0.2, penalty2=0.9)
    out = SGM_FORMS[form](vol, left, 0.2, 0.9)
    assert torch.equal(out, ref)


def test_sgm_forms_equal_at_teddy(device, launches):
    """Both forms at the teddy shape, float32 and bf16: torch.equal, each
    through its own entry points, and the rule takes the side-by-side
    form there."""
    left, right = _images(375, 450, 21, device)
    for dtype, sfx in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        vol = cost_ops.ssd_cost_volume(left, right, max_disparity=128,
                                       kernel_size=7, cost_dtype=dtype)
        launches.clear()
        serial = sgm_cuda._aggregate_serial(vol, left, 0.1, 0.2)
        assert _sgm_launches(launches, sfx) == dict(
            rows=6, horizontal=2, side_by_side=0, fold=0)
        launches.clear()
        side = sgm_cuda._aggregate_side_by_side(vol, left, 0.1, 0.2)
        assert _sgm_launches(launches, sfx) == dict(
            rows=0, horizontal=0, side_by_side=1, fold=1)
        assert side.dtype == dtype and torch.equal(side, serial)
        launches.clear()
        assert torch.equal(sgm_cuda.semiglobal_aggregate_cuda(
            vol, left, penalty1=0.1, penalty2=0.2), serial)
        assert _sgm_launches(launches, sfx) == _sgm_counts(vol.shape)
        assert launches[f"stm_sgm_side_by_side_{sfx}"] == 1


def _family_sums(vol, image):
    """The horizontal and row families of ``vol`` through the kernels,
    each family summed in TRAVERSALS order."""
    out = []
    for steps in (agg_ops.TRAVERSALS[:2], agg_ops.TRAVERSALS[2:]):
        acc = torch.empty_like(vol)
        for i, step in enumerate(steps):
            sgm_cuda.traverse_cuda(vol, image, acc, step, 0.2, 0.9,
                                   accumulate=i > 0)
        out.append(acc)
    return out


@pytest.mark.parametrize("form", SGM_FORMS)
def test_sgm_ring_misaligned_volume_takes_element_copies(device, form):
    """A volume 4 bytes off a 16-byte boundary (D % 4 == 0) cannot take
    16-byte copies; the kernels copy element by element and agree."""
    left, right = _images(19, 27, 8, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=96,
                                   kernel_size=3)              # VPL 4
    flat = torch.empty(vol.numel() + 1, device=device)
    shifted = flat[1:].view(vol.shape)
    shifted.copy_(vol)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    for got, want in zip(_family_sums(shifted, left),
                         _family_sums(vol, left)):
        assert torch.equal(got, want)
    assert torch.equal(SGM_FORMS[form](shifted, left, 0.1, 0.2),
                       agg_ops.semiglobal_aggregate(vol, left))


@pytest.mark.parametrize("form", SGM_FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_sgm_kernel_nan_and_inf_like_plain(device, form, dtype):
    """A pixel whose costs are all +inf gives inf - inf in the band; the
    kernels must produce what the plain version produces, NaN included
    (and every NaN's bits: the same operations in the same order)."""
    left, right = _images(9, 14, 1, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=6,
                                   kernel_size=2, cost_dtype=dtype)
    vol[4, 7, :] = float("inf")
    vol[2, 3, 1] = float("-inf")
    ref = agg_ops.semiglobal_aggregate(vol, left)
    out = SGM_FORMS[form](vol, left, 0.1, 0.2)
    assert torch.isnan(ref).any() and torch.isinf(ref).any()
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    keep = ~torch.isnan(ref)
    assert torch.equal(out[keep], ref[keep])
    if form == "side_by_side":
        serial = sgm_cuda._aggregate_serial(vol, left, 0.1, 0.2)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        assert torch.equal(out.view(bits), serial.view(bits))


def test_main_path_goes_through_kernels(device, launches):
    """At 48x80 D=16 the rule takes the side-by-side form: one launch of
    the first seven traversals and one of the folding last."""
    left, right, _ = stereo_pair(48, 80, 16, seed=7)
    assert sgm_cuda._takes_side_by_side(48, 80, 16)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=16)
    disp = pipe.estimate(left, right, device=device)
    assert disp.is_cuda
    assert launches["stm_ssd_f32"] == 1
    assert _sgm_launches(launches) == dict(rows=0, horizontal=0,
                                           side_by_side=1, fold=1)
    plain = pipe.estimate(left, right, device="cpu")
    assert torch.equal(disp.cpu(), plain)


def test_wta_ties_go_to_lower_disparity_on_cuda(device):
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 2, (32, 48, 64)).astype(np.float32)
    out = cli_common.DISPARITY_METHODS["wta"]()(torch.from_numpy(vol).to(device))
    np.testing.assert_array_equal(out.cpu().numpy(), np.argmin(vol, axis=2))


def test_sgm_rows_kernel_bit_equal_at_hd(device):
    """K4, the TPU's W-on-grid SGM pass, exists for HD's VMEM; its
    counterpart here is sgm_rows_kernel itself, held at 1024x1280 D=256
    for one row traversal."""
    left, right = _images(1024, 1280, 11, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=256,
                                   kernel_size=7)
    ref = agg_ops.sweep(vol, left, 0.1, 0.2, (1, 0))
    out = torch.empty_like(vol)
    sgm_cuda.traverse_cuda(vol, left, out, (1, 0), 0.1, 0.2,
                           accumulate=False)
    assert torch.equal(out, ref)


def test_sgm_horizontal_kernel_bit_equal_at_hd(device):
    """The horizontal family at 1024x1280 D=256 (16-byte copies, VPL 8),
    both traversals, the second added onto the first."""
    left, right = _images(1024, 1280, 12, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=256,
                                   kernel_size=7)
    ref = agg_ops.sweep(vol, left, 0.1, 0.2, (0, 1))
    ref += agg_ops.sweep(vol, left, 0.1, 0.2, (0, -1))
    out = torch.empty_like(vol)
    for i, step in enumerate(agg_ops.TRAVERSALS[:2]):
        sgm_cuda.traverse_cuda(vol, left, out, step, 0.1, 0.2,
                               accumulate=i > 0)
    assert torch.equal(out, ref)


# csrc/dp.cu: the forward pass holds J = 1..16 disparities a lane (16-byte
# pieces and J-byte pointer stores only for D % 16 == 0), the walk takes
# batches of 32 columns with windows of +-64 disparities.  W around and
# off a batch, W = 1, D around 64 (the window covers the whole band below
# it), D = 1 and D = 300 (J = 16 with padding lanes).
DP_SHAPES = [(37, 53, 24), (5, 1, 7), (6, 9, 1), (64, 96, 40), (20, 31, 300),
             (9, 70, 128), (7, 31, 48), (7, 32, 48), (7, 33, 48),
             (5, 97, 96), (6, 80, 63), (6, 80, 64), (6, 80, 65),
             (4, 200, 1)]


@pytest.mark.parametrize("shape", DP_SHAPES, ids=str)
def test_dp_kernels_bit_equal(device, shape):
    h, w, d = shape
    rng = np.random.default_rng(h * w + d)
    vol = torch.from_numpy(rng.random(shape, np.float32)).to(device)
    ref_ptr, ref_final = disp_ops.dp_forward(vol)
    ptr, final = dp_cuda.dp_forward_cuda(vol)
    assert torch.equal(ptr, ref_ptr) and torch.equal(final, ref_final)
    ref = disp_ops.dp_backward(ref_ptr, disp_ops.dp_end_disparities(
        ref_final))
    assert torch.equal(dp_cuda.dp_backward_cuda(ptr, final), ref)


def _dp_both_equal(vol):
    """Both kernels against the plain steps: pointers, final costs and
    disparities bit-equal."""
    ref_ptr, ref_final = disp_ops.dp_forward(vol)
    ptr, final = dp_cuda.dp_forward_cuda(vol)
    assert torch.equal(ptr, ref_ptr) and torch.equal(final, ref_final)
    ref = disp_ops.dp_backward(ref_ptr, disp_ops.dp_end_disparities(
        ref_final))
    assert torch.equal(dp_cuda.dp_backward_cuda(ptr, final), ref)


def test_dp_kernels_bit_equal_at_hd(device):
    """HD 1024x1280 D=256 on an SSD volume: 40 batches of the walk a row,
    the forward pass's 8-byte pointer stores."""
    left, right = _images(1024, 1280, 13, device)
    _dp_both_equal(cost_ops.ssd_cost_volume(left, right, max_disparity=256,
                                            kernel_size=7))


@pytest.mark.parametrize("case", DP_RAMP_CASES, ids=str)
def test_dp_kernels_on_ramp_volumes(device, case):
    """Minima that ramp by +-1 a column and saturate at the band's edges
    (held against JAX on the CPU by tests/test_torch_dp.py): the walk runs
    to its window's edge."""
    _dp_both_equal(torch.from_numpy(ramp_cost_volume(*case)).to(device))


def test_dp_forward_on_a_misaligned_volume(device):
    """D % 16 == 0 but the cost volume 4 bytes past a 16-byte boundary:
    4-byte pieces and byte stores."""
    h, w, d = 9, 45, 64
    rng = np.random.default_rng(21)
    vol = torch.from_numpy(rng.random((h, w, d), np.float32)).to(device)
    buf = torch.empty(vol.numel() + 1, device=device)
    buf[1:] = vol.reshape(-1)
    shifted = buf[1:].view(h, w, d)
    assert shifted.data_ptr() % 16 == 4
    _dp_both_equal(shifted)


def _pointer_volume(kind, shape, rng):
    if kind == "all_minus":
        return np.full(shape, -1, np.int8)
    if kind == "all_plus":
        return np.ones(shape, np.int8)
    if kind == "mix":
        return rng.integers(-1, 2, shape).astype(np.int8)
    return rng.integers(-128, 128, shape).astype(np.int8)     # wild


@pytest.mark.parametrize("shape", [(5, 97, 65), (4, 300, 256), (3, 64, 1),
                                   (6, 33, 300), (3, 1, 20)], ids=str)
@pytest.mark.parametrize("kind", ["all_minus", "all_plus", "mix", "wild"])
def test_dp_backward_on_hand_made_pointers(device, kind, shape):
    """The walk on any int8 pointers, as the plain walk takes them: all
    -1 and all +1 drive it into both clips, a mix of {-1, 0, +1} stays in
    its windows, and values outside {-1, 0, +1} leave them, where the
    kernel reads the pointer from device memory.  End disparities at
    both edges of the band and inside it."""
    rng = np.random.default_rng(shape[1] * shape[2])
    ptr = torch.from_numpy(_pointer_volume(kind, shape, rng)).to(device)
    h, _, d = shape
    final = torch.from_numpy(rng.random((h, d), np.float32))
    final[0, 0] = -1.0
    if h > 1:
        final[1, d - 1] = -1.0
    final = final.to(device)
    ref = disp_ops.dp_backward(ptr, disp_ops.dp_end_disparities(final))
    assert torch.equal(dp_cuda.dp_backward_cuda(ptr, final), ref)


def test_dp_backward_argmin_nan_and_signed_zero(device):
    """The final column's argmin follows torch.argmin: the first NaN wins,
    else the smallest value with the lowest d on ties, -0 equal to +0."""
    d = 100
    rows = [np.full(d, 3.0, np.float32) for _ in range(8)]
    rows[0][[40, 70]] = np.nan                  # first NaN: 40
    rows[1][[5, 90]] = [-1.0, np.nan]           # a NaN beats a smaller value
    rows[2][[33, 64]] = [-0.0, 0.0]             # -0 first: 33
    rows[3][[10, 75]] = [0.0, -0.0]             # +0 first: 10
    rows[4][[31, 32, 95]] = 1.0                 # ties across lanes: 31
    rows[5][:] = np.inf                         # all +inf: 0
    rows[6][[63, 99]] = np.nan                  # first NaN past a lane: 63
    rows[7][[1, 97]] = -np.inf                  # -inf ties: 1
    final = torch.from_numpy(np.stack(rows)).to(device)
    rng = np.random.default_rng(6)
    ptr = torch.from_numpy(rng.integers(-1, 2, (8, 50, d)).astype(
        np.int8)).to(device)
    ends = disp_ops.dp_end_disparities(final)
    assert ends.cpu().tolist() == [40, 90, 33, 10, 31, 0, 63, 1]
    ref = disp_ops.dp_backward(ptr, ends)
    assert torch.equal(dp_cuda.dp_backward_cuda(ptr, final), ref)


@pytest.mark.parametrize("kind", ["ssd_wedge", "ties", "distinct"])
def test_dp_kernels_ties_and_wedge(device, kind):
    rng = np.random.default_rng(2)
    if kind == "ssd_wedge":
        left, right = _images(33, 60, 4, device)
        vol = cost_ops.ssd_cost_volume(left, right, max_disparity=20,
                                       kernel_size=3)
    elif kind == "ties":
        vol = torch.from_numpy(rng.integers(0, 2, (16, 40, 33)).astype(
            np.float32)).to(device)
    else:
        vol = torch.from_numpy(rng.permutation(16 * 24 * 64).reshape(
            16, 24, 64).astype(np.float32)).to(device)
    assert torch.equal(dp_cuda.dynamic_programming_cuda(vol),
                       disp_ops.dynamic_programming(vol))


# (H, W, D, radius, wedge_offset, misaligned): the kernels' tile is 32
# output columns, 16 / 8 / 4 disparities and row chunks of at least 4r
# rows, walked in groups of 4 (2 at r = 0).
CVF_SHAPES = [(20, 30, 12, 3, 0, False), (17, 25, 8, 2, 3, False),
              (33, 41, 16, 8, 0, False), (12, 40, 16, 1, 0, False),
              (24, 26, 5, 4, 0, False), (8, 12, 4, 0, 0, False),
              (37, 53, 24, 8, 0, False), (30, 300, 100, 8, 1, False),
              (40, 20, 16, 8, 0, False),     # W < 32
              (9, 70, 1, 8, 0, False),       # H < 2r + 1, D = 1
              (203, 45, 37, 8, 3, False),    # H not a multiple of a chunk
              (50, 33, 129, 8, 0, False),    # D = 129
              (30, 50, 16, 20, 0, False), (70, 40, 8, 32, 2, False),
              (64, 33, 40, 8, 0, True), (21, 34, 7, 5, 2, True)]


def _cvf_equal(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    fin = torch.isfinite(ref)
    assert torch.equal(fin, torch.isfinite(out))
    assert torch.equal(out[~fin], ref[~fin])
    assert torch.equal(out, ref), float((out[fin] - ref[fin]).abs().max())


@pytest.mark.parametrize("shape", CVF_SHAPES, ids=str)
def test_cvf_kernels_within_bound(device, shape):
    h, w, d, r, off, misaligned = shape
    rng = np.random.default_rng(h + w)
    vol = rng.random((h, w, d), np.float32)
    x, dd = np.meshgrid(np.arange(w), np.arange(d), indexing="ij")
    vol[:, x < dd + off] = np.inf
    vol = torch.from_numpy(vol).to(device)
    if misaligned:
        # A contiguous volume 4 bytes past a 16-byte boundary.
        buf = torch.empty(vol.numel() + 1, device=device)
        buf[1:] = vol.reshape(-1)
        vol = buf[1:].view(h, w, d)
        assert vol.data_ptr() % 16 == 4
    guide = torch.from_numpy(rng.random((h, w), np.float32)).to(device)
    kw = dict(radius=r, eps=1e-4, wedge_offset=off)
    _cvf_equal(cvf_cuda.guided_filter_aggregate_cuda(vol, guide, **kw),
               cvf_ops.guided_filter_aggregate(vol, guide, **kw))


def test_cvf_kernels_refuse_a_radius_past_shared_memory(device):
    vol = torch.zeros(4, 8, 4, device=device)
    with pytest.raises(ValueError, match="shared memory"):
        cvf_cuda.guided_filter_aggregate_cuda(vol, vol[:, :, 0], radius=40)


def test_census_plain_on_card_equals_cpu(device):
    left, right = _images(40, 64, 9, device)
    kw = dict(max_disparity=24, window_size=7, kernel_size=3)
    out = cost_ops.census_hamming_cost_volume(left, right, **kw)
    ref = cost_ops.census_hamming_cost_volume(left.cpu(), right.cpu(), **kw)
    assert out.is_cuda and torch.equal(out.cpu(), ref)


@pytest.mark.parametrize("cost,aggr,reducer", [("ssd", "sgm", "dyn"),
                                               ("census", "cvf", "wta"),
                                               ("census", "cvf", "dyn")])
def test_new_paths_go_through_kernels(device, launches, cost, aggr,
                                      reducer):
    left, right, _ = stereo_pair(48, 80, 16, seed=7)
    pipe = cli_common.create_pipeline(cost, reducer, aggr, max_disparity=16)
    disp = pipe.estimate(left, right)             # the card by default
    assert disp.is_cuda
    dp_runs = 1 if reducer == "dyn" else 0
    cvf_runs = 1 if aggr == "cvf" else 0
    assert (launches["stm_dp_forward_f32"] == launches["stm_dp_backward"]
            == dp_runs)
    assert (launches["stm_cvf_stats_f32"] == launches["stm_cvf_filter_f32"]
            == cvf_runs)
    plain = pipe.estimate(left, right, device="cpu")
    assert torch.equal(disp.cpu(), plain)


def _chunks_against_plain(vol, image, step, cuts):
    """Each chunk in scan order through the kernel and the plain version,
    both from the plain version's carry of the chunk before it."""
    edges = [0, *cuts, vol.shape[0]]
    spans = list(zip(edges[:-1], edges[1:]))
    carry = (None, None)
    for rank, (a, b) in enumerate(spans if step[0] > 0 else spans[::-1]):
        kw = dict(penalty1=0.1, penalty2=0.2, seed=rank == 0)
        ref, ref_carry = agg_ops.sweep_chunk_with_carry(
            vol[a:b], image[a:b], step, *carry, **kw)
        out, out_carry = sgm_cuda.sweep_chunk_with_carry_cuda(
            vol[a:b], image[a:b], step, *carry, **kw)
        assert torch.equal(out, ref), (step, a, b)
        assert torch.equal(out_carry[0], ref_carry[0]), (step, a, b)
        assert torch.equal(out_carry[1], ref_carry[1]), (step, a, b)
        carry = ref_carry


@pytest.mark.parametrize("shape,cuts", [
    ((375, 450, 128, 7), (75, 150, 225, 300)),      # teddy, 5 tiles
    ((37, 53, 24, 3), (12,)),                        # ragged, 12 + 25
    ((1024, 1280, 256, 7), (256, 512, 768)),         # HD, 4 tiles (K6)
    *CHUNK_SHORT_CASES],                             # 1, 3, 7, 1 rows
    ids=["teddy", "ragged", "hd", "short-d1", "short-d37", "short-d129"])
def test_sgm_chunk_kernel_bit_equal_with_carry(device, shape, cuts):
    h, w, d, k = shape
    left, right = _images(h, w, h + 2 * w, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=d,
                                   kernel_size=k)
    for step in agg_ops.TRAVERSALS[2:]:
        _chunks_against_plain(vol, left, step, cuts)


def test_sgm_chunk_kernel_accumulates_and_refuses(device):
    left, right = _images(20, 30, 4, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=12,
                                   kernel_size=2)
    ref, carry = agg_ops.sweep_chunk_with_carry(
        vol[:8], left[:8], (1, 1), penalty1=0.1, penalty2=0.2, seed=True)
    part, _ = agg_ops.sweep_chunk_with_carry(
        vol[8:], left[8:], (1, 1), *carry, penalty1=0.1, penalty2=0.2,
        seed=False)
    out = torch.ones_like(vol[8:])
    sgm_cuda.sweep_chunk_with_carry_cuda(
        vol[8:], left[8:], (1, 1), *carry, penalty1=0.1, penalty2=0.2,
        seed=False, out=out, accumulate=True)
    assert torch.equal(out, torch.ones_like(out) + part)
    with pytest.raises(ValueError, match="carry"):
        sgm_cuda.sweep_chunk_with_carry_cuda(vol, left, (1, 0), penalty1=0.1,
                                             penalty2=0.2, seed=False)
    with pytest.raises(ValueError, match="row traversal"):
        sgm_cuda.sweep_chunk_with_carry_cuda(vol, left, (0, 1), penalty1=0.1,
                                             penalty2=0.2, seed=True)


@pytest.mark.parametrize("misaligned", [False, True],
                         ids=["aligned", "misaligned"])
def test_sgm_chunk_kernel_accumulates_into_out_views(device, misaligned):
    """A ring-length (8-row) chunk added into a row slice of a larger
    out volume, as the sharded path adds it; with ``misaligned`` that
    volume starts 4 bytes past a 16-byte boundary, so D % 4 == 0 does not
    buy 16-byte copies and stores."""
    h, w, d = 20, 33, 96
    left, right = _images(h, w, 6, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=d,
                                   kernel_size=3)
    ref, carry = agg_ops.sweep_chunk_with_carry(
        vol[:5], left[:5], (1, -1), penalty1=0.1, penalty2=0.2, seed=True)
    part, ref_carry = agg_ops.sweep_chunk_with_carry(
        vol[5:13], left[5:13], (1, -1), *carry, penalty1=0.1, penalty2=0.2,
        seed=False)
    buf = torch.empty(vol.numel() + int(misaligned), device=device)
    out = buf[int(misaligned):].view(h, w, d)
    out.fill_(0.5)
    assert (out[5:13].data_ptr() % 16 == 0) != misaligned
    _, out_carry = sgm_cuda.sweep_chunk_with_carry_cuda(
        vol[5:13], left[5:13], (1, -1), *carry, penalty1=0.1, penalty2=0.2,
        seed=False, out=out[5:13], accumulate=True)
    assert torch.equal(out[5:13], torch.full_like(part, 0.5) + part)
    assert torch.equal(out[:5], torch.full_like(out[:5], 0.5))
    assert torch.equal(out[13:], torch.full_like(out[13:], 0.5))
    assert torch.equal(out_carry[0], ref_carry[0])


@pytest.mark.parametrize("reducer,key", [("wta", "wta"),
                                         ("dynamic_programming", "dp")])
def test_sharded_teddy_on_one_card_reproduces_golden(device, launches,
                                                     reducer, key):
    """5 row tiles on cuda:0: the exact hand-off through the chunk kernel,
    30 launches a frame and no whole-image row launch."""
    g = np.load(Path(__file__).parent / "data" / "golden_teddy_disparity.npz")
    d = int(g["max_disparity"])
    left, right, _ = stereo_pair(int(g["height"]), int(g["width"]), d,
                                 seed=int(g["seed"]))
    pipe = ShardedPipeline(make_mesh([device] * 5, n_batch=1), d,
                           kernel_size=int(g["kernel_size"]),
                           reducer=reducer, penalty1=float(g["penalty1"]),
                           penalty2=float(g["penalty2"]))
    out = pipe.estimate(left, right)
    assert out.device == device
    assert launches["stm_sgm_chunk_f32"] == 30
    assert launches["stm_sgm_rows_f32"] == 0
    np.testing.assert_array_equal(out.cpu().numpy(), g[key])


# bf16 volumes (ROADMAP A.7): every kernel's bf16 instantiation against
# its plain version, bit for bit, at the edges above.  A bf16 volume may
# start at any 2-byte boundary: the views below sit 1, 2 and 3 elements
# past an allocation (2, 4 and 6 bytes off 16).

BF16 = torch.bfloat16


def _offset_view(vol, elements):
    """A contiguous copy of ``vol`` that starts ``elements`` past its
    buffer's (16-byte-aligned) start."""
    buf = torch.empty(vol.numel() + elements, dtype=vol.dtype,
                      device=vol.device)
    view = buf[elements:].view(vol.shape)
    view.copy_(vol)
    assert view.is_contiguous()
    assert view.data_ptr() % 16 == (elements * vol.element_size()) % 16
    return view


@pytest.mark.parametrize("absolute", [False, True], ids=["ssd", "sad"])
@pytest.mark.parametrize("shape", SHAPES + SSD_EDGE_SHAPES, ids=str)
def test_ssd_kernel_bf16_bit_equal(device, shape, absolute):
    h, w, d, k = shape
    left, right = _images(h, w, h + w, device)
    kw = dict(max_disparity=d, kernel_size=k, cost_dtype=BF16,
              absolute=absolute)
    ref = cost_ops._diff_cost_volume(left, right, **kw)
    out = ssd_cuda.diff_cost_volume_cuda(left, right, **kw)
    assert out.dtype == BF16 and torch.equal(out, ref)


def test_ssd_kernel_bf16_counts_its_launches_and_takes_bf16_images(
        device, launches):
    left, right = _images(21, 40, 5, device)
    left, right = left.to(BF16), right.to(BF16)
    kw = dict(max_disparity=24, kernel_size=3, cost_dtype=BF16,
              absolute=False)
    out = ssd_cuda.diff_cost_volume_cuda(left, right, **kw)
    assert torch.equal(out, cost_ops._diff_cost_volume(left, right, **kw))
    assert (launches["stm_ssd_f32"], launches["stm_ssd_bf16"]) == (0, 1)


def _bf16_ssd(h, w, d, k, seed, device):
    left, right = _images(h, w, seed, device)
    return left, cost_ops.ssd_cost_volume(left, right, max_disparity=d,
                                          kernel_size=k, cost_dtype=BF16)


@pytest.mark.parametrize("form", SGM_FORMS)
@pytest.mark.parametrize("shape", SGM_SHAPES, ids=str)
def test_sgm_kernels_bf16_bit_equal(device, shape, form):
    """Seven traversals into the float32 partial sum, the eighth rounding
    it into the bf16 result: equal to the plain version's one rounding."""
    h, w, d, k = shape
    left, vol = _bf16_ssd(h, w, d, k, 2 * h + w, device)
    ref = agg_ops.semiglobal_aggregate(vol, left, penalty1=0.2, penalty2=0.9)
    out = SGM_FORMS[form](vol, left, 0.2, 0.9)
    assert out.dtype == BF16 and torch.equal(out, ref)


@pytest.mark.parametrize("form", SGM_FORMS)
@pytest.mark.parametrize("elements", [1, 2, 3])
@pytest.mark.parametrize("d", [96, 37])
def test_sgm_kernels_bf16_on_misaligned_views(device, elements, d, form):
    """bf16 rows at every 2-byte offset: the ring copies the aligned
    16-byte pieces that hold them."""
    left, vol = _bf16_ssd(19, 27, d, 3, 8, device)
    shifted = _offset_view(vol, elements)
    ref = agg_ops.semiglobal_aggregate(vol, left)
    assert torch.equal(SGM_FORMS[form](shifted, left, 0.1, 0.2), ref)


def test_sgm_kernels_bf16_at_hd(device):
    """Both families at 1024x1280 D=256 on a bf16 volume, the row family
    ending in the rounded result."""
    left, vol = _bf16_ssd(1024, 1280, 256, 7, 11, device)
    ref = agg_ops.semiglobal_aggregate(vol, left, penalty1=0.1, penalty2=0.2)
    out = sgm_cuda.semiglobal_aggregate_cuda(vol, left, penalty1=0.1,
                                             penalty2=0.2)
    assert torch.equal(out, ref)


def test_sgm_kernels_bf16_refuse_a_misplaced_result(device):
    left, vol = _bf16_ssd(6, 9, 8, 2, 1, device)
    out = torch.zeros(vol.shape, device=device)
    with pytest.raises(ValueError, match="accumulate"):
        sgm_cuda.traverse_cuda(vol, left, out, (1, 0), 0.1, 0.2,
                               accumulate=False,
                               result=torch.empty_like(vol))
    with pytest.raises(ValueError, match="horizontal"):
        sgm_cuda.traverse_cuda(vol, left, out, (0, 1), 0.1, 0.2,
                               accumulate=True, result=torch.empty_like(vol))


def _bf16_chunks_against_plain(vol, image, step, cuts, final):
    """As _chunks_against_plain on a bf16 volume; with ``final`` each
    chunk also adds onto a float32 partial and rounds into a bf16 result,
    as the sharded path's last traversal does."""
    edges = [0, *cuts, vol.shape[0]]
    spans = list(zip(edges[:-1], edges[1:]))
    carry = (None, None)
    for rank, (a, b) in enumerate(spans if step[0] > 0 else spans[::-1]):
        kw = dict(penalty1=0.1, penalty2=0.2, seed=rank == 0)
        ref, ref_carry = agg_ops.sweep_chunk_with_carry(
            vol[a:b], image[a:b], step, *carry, **kw)
        if final:
            partial = torch.full(ref.shape, 0.75, device=vol.device)
            result = torch.empty(ref.shape, dtype=BF16, device=vol.device)
            out, out_carry = sgm_cuda.sweep_chunk_with_carry_cuda(
                vol[a:b], image[a:b], step, *carry, out=partial,
                accumulate=True, result=result, **kw)
            assert out is result and torch.equal(partial, torch.full_like(
                partial, 0.75))
            ref = (ref + 0.75).to(BF16)
        else:
            out, out_carry = sgm_cuda.sweep_chunk_with_carry_cuda(
                vol[a:b], image[a:b], step, *carry, **kw)
            assert out.dtype == torch.float32
        assert torch.equal(out, ref), (step, a, b)
        assert torch.equal(out_carry[0], ref_carry[0]), (step, a, b)
        assert torch.equal(out_carry[1], ref_carry[1]), (step, a, b)
        carry = ref_carry


@pytest.mark.parametrize("final", [False, True], ids=["partial", "final"])
@pytest.mark.parametrize("shape,cuts", [
    ((375, 450, 128, 7), (75, 150, 225, 300)),
    ((37, 53, 24, 3), (12,)),
    ((1024, 1280, 256, 7), (256, 512, 768)),
    *CHUNK_SHORT_CASES],
    ids=["teddy", "ragged", "hd", "short-d1", "short-d37", "short-d129"])
def test_sgm_chunk_kernel_bf16_bit_equal_with_carry(device, shape, cuts,
                                                    final):
    h, w, d, k = shape
    left, vol = _bf16_ssd(h, w, d, k, h + 2 * w, device)
    steps = agg_ops.TRAVERSALS[2:] if not final or h < 1000 else \
        agg_ops.TRAVERSALS[-1:]
    for step in steps:
        _bf16_chunks_against_plain(vol, left, step, cuts, final)


@pytest.mark.parametrize("shape", DP_SHAPES, ids=str)
def test_dp_forward_kernel_bf16_bit_equal(device, shape):
    rng = np.random.default_rng(sum(shape))
    vol = torch.from_numpy(rng.random(shape, np.float32)).to(device).to(BF16)
    _dp_both_equal(vol)


@pytest.mark.parametrize("case", DP_RAMP_CASES, ids=str)
def test_dp_kernels_bf16_on_ramp_volumes(device, case):
    _dp_both_equal(torch.from_numpy(ramp_cost_volume(*case)).to(device).to(
        BF16))


@pytest.mark.parametrize("elements", [1, 2, 3, 8])
def test_dp_forward_bf16_on_misaligned_views(device, elements):
    """D % 16 == 0 and odd D, each 2 to 16 bytes off a 16-byte boundary."""
    rng = np.random.default_rng(elements)
    for shape in ((9, 45, 64), (7, 33, 37)):
        vol = torch.from_numpy(rng.random(shape, np.float32)).to(device)
        _dp_both_equal(_offset_view(vol.to(BF16), elements))


def test_dp_kernels_bf16_at_hd(device, launches):
    _, vol = _bf16_ssd(1024, 1280, 256, 7, 13, device)
    _dp_both_equal(vol)
    assert (launches["stm_dp_forward_f32"],
            launches["stm_dp_forward_bf16"]) == (0, 1)


@pytest.mark.parametrize("shape", CVF_SHAPES, ids=str)
def test_cvf_kernels_bf16_bit_equal(device, shape):
    """bf16 volumes in, float32 a0/b0, q rounded once to bf16; the
    misaligned cases start one element (2 bytes) past a 16-byte
    boundary."""
    h, w, d, r, off, misaligned = shape
    rng = np.random.default_rng(h + w + 1)
    vol = rng.random((h, w, d), np.float32)
    x, dd = np.meshgrid(np.arange(w), np.arange(d), indexing="ij")
    vol[:, x < dd + off] = np.inf
    vol = torch.from_numpy(vol).to(device).to(BF16)
    if misaligned:
        vol = _offset_view(vol, 1)
    guide = torch.from_numpy(rng.random((h, w), np.float32)).to(device)
    kw = dict(radius=r, eps=1e-4, wedge_offset=off)
    _cvf_equal(cvf_cuda.guided_filter_aggregate_cuda(vol, guide, **kw),
               cvf_ops.guided_filter_aggregate(vol, guide, **kw))


def test_wta_on_bf16_takes_the_first_minimum_and_nan(device):
    """torch.argmin on a bf16 CUDA volume: ties (many after rounding) to
    the lowest disparity, a NaN before any number, as on the CPU and as
    jnp.argmin."""
    rng = np.random.default_rng(3)
    vol = torch.from_numpy(rng.integers(0, 3, (32, 48, 64)).astype(
        np.float32)).to(BF16)
    vol[3, 5, [7, 40]] = float("nan")
    vol[4, 6, :] = float("inf")
    vol[5, 7, [10, 30]] = -0.0
    want = disp_ops.winner_takes_all(vol)
    out = cli_common.DISPARITY_METHODS["wta"]()(vol.to(device))
    assert torch.equal(out.cpu(), want)
    assert want[3, 5] == 7 and want[4, 6] == 0


@pytest.mark.parametrize("cost,aggr,reducer", [
    ("ssd", "sgm", "wta"), ("ssd", "sgm", "dyn"), ("census", "cvf", "wta"),
    ("sad", None, "dyn")])
def test_bf16_paths_go_through_the_bf16_kernels(device, launches, cost,
                                                aggr, reducer):
    left, right, _ = stereo_pair(48, 80, 16, seed=7)
    pipe = cli_common.create_pipeline(cost, reducer, aggr, max_disparity=16,
                                      volume_dtype="bfloat16")
    disp = pipe.estimate(left, right)
    assert disp.is_cuda and disp.dtype == torch.int32
    assert pipe._aggregation_volume.dtype == BF16
    assert not any(name.endswith(("_f32", "_i32")) for name in launches
                   if launches[name])
    assert launches["stm_ssd_bf16"] == (cost != "census")
    assert _sgm_launches(launches, "bf16") == _sgm_counts(
        (48, 80, 16), frames=int(aggr == "sgm"))
    assert launches["stm_dp_forward_bf16"] == (reducer == "dyn")
    assert launches["stm_cvf_stats_bf16"] == (aggr == "cvf")
    assert launches["stm_cvf_filter_bf16"] == (aggr == "cvf")
    plain = pipe.estimate(left, right, device="cpu")
    assert torch.equal(disp.cpu(), plain)


@pytest.mark.parametrize("mode", ["exact", "overlap"])
def test_sharded_bf16_on_one_card_equals_single_card(device, launches,
                                                     mode):
    """5 row tiles of a bf16 teddy volume on cuda:0: each tile's sum
    rounded once, so the disparities equal the single-card bf16 path."""
    g = np.load(Path(__file__).parent / "data" / "golden_teddy_disparity.npz")
    d = int(g["max_disparity"])
    left, right, _ = stereo_pair(int(g["height"]), int(g["width"]), d,
                                 seed=int(g["seed"]))
    kw = dict(penalty1=float(g["penalty1"]), penalty2=float(g["penalty2"]))
    single = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=d,
                                        volume_dtype="bfloat16", **kw)
    single.cost.kernel_size = int(g["kernel_size"])
    want = single.estimate(left, right)
    launches.clear()
    pipe = ShardedPipeline(make_mesh([device] * 5, n_batch=1), d,
                           kernel_size=int(g["kernel_size"]),
                           cost_dtype="bfloat16", sgm_mode=mode,
                           overlap=300, **kw)
    assert torch.equal(pipe.estimate(left, right), want)
    assert launches["stm_sgm_chunk_bf16"] == (30 if mode == "exact" else 0)


def _uint8_pair(h, w, d, seed):
    left, right, _ = stereo_pair(h, w, d, seed=seed)
    return (left * 255).astype(np.uint8), (right * 255).astype(np.uint8)


@pytest.mark.parametrize("cost", ["ssd", "sad"])
def test_int32_volume_to_dyn_equals_plain(device, launches, cost):
    """The int32 chain's volume reaches the DP reducer as int32; the
    forward launcher widens it to float32, as the plain version does, and
    the card path's disparities equal the plain path's."""
    left, right = _uint8_pair(48, 80, 16, 7)
    pipe = cli_common.create_pipeline(cost, "dyn", None, max_disparity=16,
                                      volume_dtype="int32")
    disp = pipe.estimate(left, right)
    assert disp.is_cuda and disp.dtype == torch.int32
    assert launches["stm_ssd_i32"] == 1
    assert launches["stm_dp_forward_f32"] == launches["stm_dp_backward"] == 1
    assert torch.equal(disp.cpu(), pipe.estimate(left, right, device="cpu"))


def test_sharded_int32_volume_to_dyn_equals_single_card(device, launches):
    """5 row tiles of an int32 volume with the DP reducer on cuda:0: each
    tile's forward pass widens to float32, so the disparities equal the
    single-card and the plain path's."""
    d = 16
    left, right = _uint8_pair(60, 96, d, 11)
    single = cli_common.create_pipeline("ssd", "dyn", None, max_disparity=d,
                                        volume_dtype="int32")
    single.cost.kernel_size = 3
    want = single.estimate(left, right)
    assert torch.equal(want.cpu(), single.estimate(left, right,
                                                   device="cpu"))
    launches.clear()
    pipe = ShardedPipeline(make_mesh([device] * 5, n_batch=1), d,
                           kernel_size=3, cost_dtype="int32",
                           aggregation=None, reducer="dynamic_programming")
    out = pipe.estimate(left, right)
    assert torch.equal(out.reshape(want.shape), want)
    assert launches["stm_dp_forward_f32"] == 5


# Fault C.1: under backend="auto" a shape that a kernel does not serve
# runs the plain version on the card; an explicit "cuda" still raises.
FAR_D = 600                 # past the SGM and DP kernels' 512


def _far_pair(device):
    """8 x 640 images, D = 600 fits in the width."""
    left, right, _ = stereo_pair(8, 640, 64, seed=4)
    return (torch.from_numpy(left).to(device),
            torch.from_numpy(right).to(device))


@pytest.mark.parametrize("reducer", ["wta", "dyn"])
def test_auto_runs_sgm_and_dp_past_their_kernels_on_the_card(device,
                                                             launches,
                                                             reducer):
    left, right = _far_pair(device)
    auto = cli_common.create_pipeline("ssd", reducer, "sgm",
                                      max_disparity=FAR_D)
    plain = cli_common.create_pipeline("ssd", reducer, "sgm",
                                       max_disparity=FAR_D, backend="torch")
    disp = auto.estimate(left, right)
    assert disp.is_cuda
    assert launches["stm_ssd_f32"] == 1
    assert launches["stm_sgm_rows_f32"] == launches["stm_dp_forward_f32"] == 0
    assert torch.equal(disp, plain.estimate(left, right))
    forced = cli_common.create_pipeline("ssd", reducer, "sgm",
                                        max_disparity=FAR_D, backend="cuda")
    with pytest.raises(ValueError, match="exceeds"):
        forced.estimate(left, right)


def test_auto_runs_the_sharded_path_past_the_chunk_kernel(device, launches):
    left, right = _far_pair(device)
    single = cli_common.create_pipeline("ssd", "dyn", "sgm",
                                        max_disparity=FAR_D)
    single.cost.kernel_size = 3
    want = single.estimate(left, right)
    launches.clear()
    mesh = make_mesh([device] * 2, n_batch=1)
    out = ShardedPipeline(mesh, FAR_D, kernel_size=3,
                          reducer="dynamic_programming").estimate(left, right)
    assert torch.equal(out.reshape(want.shape), want)
    assert launches["stm_sgm_chunk_f32"] == launches["stm_dp_backward"] == 0
    with pytest.raises(ValueError, match="exceeds"):
        ShardedPipeline(mesh, FAR_D, kernel_size=3,
                        backend="cuda").estimate(left, right)


def test_auto_runs_cvf_past_its_radius_on_the_card(device, launches):
    left, right = _images(40, 72, 6, device)
    kw = dict(max_disparity=24, cvf_radius=40)
    disp = cli_common.create_pipeline("census", "wta", "cvf",
                                      **kw).estimate(left, right)
    assert disp.is_cuda and launches["stm_cvf_stats_f32"] == 0
    plain = cli_common.create_pipeline("census", "wta", "cvf",
                                       backend="torch", **kw)
    assert torch.equal(disp, plain.estimate(left, right))
    with pytest.raises(ValueError, match="shared memory"):
        cli_common.create_pipeline("census", "wta", "cvf", backend="cuda",
                                   **kw).estimate(left, right)


def test_auto_runs_ssd_past_its_window_on_the_card(device, launches):
    from stereomatch_tpu_torch.cost import SSD
    left, right = _images(4, 8, 1, device)
    out = SSD(4, kernel_size=SSD_REFUSED_K)(left, right)
    assert launches["stm_ssd_f32"] == 0
    assert torch.equal(out, SSD(4, kernel_size=SSD_REFUSED_K,
                                backend="torch")(left, right))
    with pytest.raises(ValueError, match="shared memory"):
        SSD(4, kernel_size=SSD_REFUSED_K, backend="cuda")(left, right)


# Post-processing (ops/refine.py) is plain PyTorch on the device of its
# input: each stage on the card equals the same stage on the CPU.
REFINED_FLAGS = [dict(), dict(lr_check=True), dict(lr_check=True,
                                                   lr_mode="volume"),
                 dict(weighted_median=True, wmf_sigma=0.1),
                 dict(fgs_lambda=16.0, fgs_sigma=0.08, lr_check=True),
                 dict(min_confidence=0.1)]


@pytest.mark.parametrize("flags", REFINED_FLAGS, ids=str)
def test_refined_pipeline_on_card_equals_cpu(device, launches, flags):
    left, right, _ = stereo_pair(48, 80, 24, seed=12)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=24)
    pipe.cost.kernel_size = 3
    out = pipe.estimate_refined(left, right, **flags)
    assert out.is_cuda and launches["stm_sgm_side_by_side_f32"] > 0
    conf = pipe.last_confidence()
    ref = pipe.estimate_refined(left, right, device="cpu", **flags)
    assert torch.equal(out.cpu(), ref)
    assert conf.is_cuda and torch.equal(conf.cpu(), pipe.last_confidence())


@pytest.mark.parametrize("flags", [dict(median=True, subpixel=True,
                                        speckle=True),
                                   dict(lr_check=True, weighted_median=True,
                                        wmf_sigma=0.1, fgs_lambda=16.0,
                                        fgs_sigma=0.08, min_confidence=0.05,
                                        speckle=True,
                                        speckle_fill="background")],
                         ids=["median-subpixel-speckle", "the-rest"])
def test_sharded_post_processing_on_card_equals_single_card(device, flags):
    from stereomatch_tpu_torch.ops.refine import filter_speckles
    left, right, _ = stereo_pair(48, 80, 24, seed=13)
    single = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=24)
    single.cost.kernel_size = 3
    keys = {k: v for k, v in flags.items() if not k.startswith("speckle")}
    keys.setdefault("median", False)
    keys.setdefault("subpixel", False)
    want = filter_speckles(single.estimate_refined(left, right, **keys),
                           fill=flags.get("speckle_fill", "zero"))
    pipe = ShardedPipeline(make_mesh([device] * 4, n_batch=1), 24,
                           kernel_size=3, **flags)
    assert torch.equal(pipe.estimate(left, right), want)


@pytest.mark.parametrize("cost", ["birchfield", "ncc", "ssd-texture"])
@pytest.mark.parametrize("h,w,d", [(37, 53, 24), (60, 96, 16)])
def test_cost_families_on_the_card_equal_the_cpu(device, launches, cost, h,
                                                 w, d):
    """Birchfield and ZNCC are plain PyTorch on the card (no kernel);
    their volumes, and SSD over textures (the SSD kernel's float32 SSD),
    equal the CPU's bit for bit, and so do the SGM paths' disparities."""
    left, right, _ = stereo_pair(h, w, d, seed=h + w)
    pipe = cli_common.create_pipeline(cost, "wta", "sgm", max_disparity=d)
    disp = pipe.estimate(left, right)
    vol = pipe._cost_volume
    assert disp.is_cuda and vol.is_cuda
    assert launches["stm_ssd_f32"] == (1 if cost == "ssd-texture" else 0)
    assert _sgm_launches(launches) == _sgm_counts((h, w, d))
    assert torch.equal(disp.cpu(), pipe.estimate(left, right, device="cpu"))
    assert torch.equal(vol.cpu(), pipe._cost_volume)


def test_ssd_texture_reaches_the_ssd_kernel_and_equals_ssd(device, launches):
    from stereomatch_tpu_torch.cost import SSD, SSDTexture
    from stereomatch_tpu_torch.texture import TextureImage
    left, right = _images(45, 70, 3, device)
    tex = SSDTexture(20, kernel_size=4)(TextureImage(left),
                                        TextureImage(right))
    assert launches["stm_ssd_f32"] == 1
    assert torch.equal(tex, SSD(20, kernel_size=4)(left, right))
    assert torch.equal(tex.cpu(), cost_ops.ssd_cost_volume(
        left.cpu(), right.cpu(), max_disparity=20, kernel_size=4))


@pytest.mark.parametrize("cost", ["birchfield", "ncc"])
def test_sharded_cost_families_equal_the_single_card(device, launches, cost):
    d = 16
    left, right, _ = stereo_pair(60, 96, d, seed=3)
    want = cli_common.create_pipeline(cost, "wta", "sgm",
                                      max_disparity=d).estimate(left, right)
    launches.clear()
    out = ShardedPipeline(make_mesh([device] * 3, n_batch=1), d,
                          cost=cost).estimate(left, right)
    assert launches["stm_sgm_chunk_f32"] == 18
    assert torch.equal(out.reshape(want.shape), want)


def test_sqrt_f32_is_correctly_rounded_on_the_card(device):
    from stereomatch_tpu_torch.utils.numeric import sqrt_f32
    x = torch.rand(1 << 20, generator=torch.Generator().manual_seed(2)) * 4
    want = torch.from_numpy(np.sqrt(x.numpy()))
    assert torch.equal(sqrt_f32(x.to(device)).cpu(), want)
    assert torch.equal(sqrt_f32(x), want)


# --------------------------------------------------------------------------
# Pipeline.compiled(): CUDA graph replay against the eager frame (A.4)
# --------------------------------------------------------------------------

COMPILED_PATHS = [("ssd", "wta", "sgm", "float32"), ("ssd", "dyn", "sgm",
                                                     "float32"),
                  ("census", "wta", "cvf", "float32"),
                  ("ssd", "wta", "sgm", "bfloat16"),
                  ("census", "dyn", "cvf", "bfloat16"),
                  ("ncc", "wta", "sgm", "float32"),
                  ("birchfield", "dyn", None, "float32"),
                  ("ssd", "dyn", None, "int32")]


@pytest.mark.parametrize("cost,reducer,aggr,dtype", COMPILED_PATHS, ids=str)
def test_compiled_replay_equals_eager(device, launches, cost, reducer, aggr,
                                      dtype):
    """Two different pairs in a row: each replay equals the eager frame
    bit for bit (the static inputs are refreshed, the first result is
    not overwritten), and the capture recorded the kernel launches of
    one eager run of ``estimate_fn``, the frame it captures."""
    pipe = cli_common.create_pipeline(cost, reducer, aggr, max_disparity=24,
                                      cvf_radius=3, volume_dtype=dtype)
    pairs = [_images(37, 53, seed, device) for seed in (1, 2)]
    want = [pipe.estimate(*p).clone() for p in pairs]
    launches.clear()
    pipe.estimate_fn()(*pairs[0])       # the frame the graph captures
    eager = collections.Counter(launches)
    fn = pipe.compiled()
    first = fn(*pairs[0])
    second = fn(*pairs[1])
    torch.cuda.synchronize()
    assert torch.equal(first, want[0]) and torch.equal(second, want[1])
    (graph,) = fn.graphs.values()
    assert graph.launches == eager
    assert graph.memory_bytes >= 0


def test_compiled_keys_a_graph_per_shape_and_takes_numpy(device):
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=16)
    fn = pipe.compiled()
    small = _images(20, 30, 3, device)
    large = _images(24, 40, 4, device)
    for pair in (small, large, small):
        assert torch.equal(fn(*pair), pipe.estimate(*pair))
    assert len(fn.graphs) == 2
    left, right = (t.cpu().numpy() for t in large)
    out = fn(left, right)
    assert out.is_cuda and torch.equal(out, pipe.estimate(*large))
    assert len(fn.graphs) == 2


def test_compiled_replays_past_the_kernels_under_auto(device, launches):
    """D = 600 under backend="auto": the SSD kernel, then the plain SGM
    and DP on the card, captured and replayed."""
    pipe = cli_common.create_pipeline("ssd", "dyn", "sgm", max_disparity=600)
    pair = _images(8, 640, 5, device)
    assert torch.equal(pipe.compiled()(*pair), pipe.estimate(*pair))


# --------------------------------------------------------------------------
# Winner-takes-all in SGM's fold (semiglobal_wta_cuda): torch.argmin's
# disparities with no volume written
# --------------------------------------------------------------------------

WTA_SHAPES = [(37, 53), (375, 450), (375, 1242)]       # teddy, KITTI
WTA_DISPARITIES = [37, 64, 100, 126, 128]   # 37, 126: 4-byte copies


def _wta_both(vol, left, **kw):
    """(the fused disparities, winner_takes_all of the aggregated volume)
    of ``vol`` over ``left``."""
    fused = sgm_cuda.semiglobal_wta_cuda(vol, left, **kw)
    summed = sgm_cuda.semiglobal_aggregate_cuda(vol, left, **kw)
    return fused, disp_ops.winner_takes_all(summed)


def _wta_plain(vol, left, **kw):
    """winner_takes_all of the plain PyTorch aggregation of ``vol``, which
    shares no code with the kernels."""
    return disp_ops.winner_takes_all(
        agg_ops.semiglobal_aggregate(vol, left, **kw))


@pytest.mark.parametrize("adaptive", [True, False],
                         ids=["adaptive", "constant"])
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", WTA_DISPARITIES)
@pytest.mark.parametrize("hw", WTA_SHAPES, ids=str)
def test_sgm_fold_wta_equals_argmin_of_the_volume(device, launches, hw, d,
                                                  dtype, adaptive):
    h, w = hw
    left, right = _images(h, w, h + d, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=d,
                                   kernel_size=3, cost_dtype=dtype)
    kw = dict(penalty1=0.05, penalty2=0.3, adaptive_p2=adaptive)
    fused, want = _wta_both(vol, left, **kw)
    assert fused.dtype == torch.int32 and fused.shape == (h, w)
    assert torch.equal(fused, want)
    assert torch.equal(fused, _wta_plain(vol, left, **kw))
    sfx = "bf16" if dtype == BF16 else "f32"
    assert launches[f"stm_sgm_fold_wta_{sfx}"] == 1
    assert launches[f"stm_sgm_fold_{sfx}"] == 1
    assert launches[f"stm_sgm_side_by_side_{sfx}"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hw", WTA_SHAPES, ids=str)
def test_sgm_fold_wta_on_integer_costs_full_of_ties(device, hw, dtype):
    """Census-like costs (integers 0-62, P1 10, P2 120 constant): many
    pixels' sums tie at their minimum, and the lowest index wins."""
    h, w = hw
    rng = np.random.default_rng(w)
    vol = torch.from_numpy(rng.integers(0, 63, (h, w, 128)).astype(
        np.float32)).to(device).to(dtype)
    left = torch.from_numpy(rng.integers(0, 256, (h, w)).astype(
        np.float32)).to(device)
    kw = dict(penalty1=10.0, penalty2=120.0, adaptive_p2=False)
    fused, want = _wta_both(vol, left, **kw)
    assert torch.equal(fused, want)
    assert torch.equal(fused, _wta_plain(vol, left, **kw))
    summed = sgm_cuda.semiglobal_aggregate_cuda(vol, left, **kw)
    ties = (summed == summed.min(dim=2, keepdim=True).values).sum(dim=2)
    assert (ties > 1).any()


def _special_rows(d):
    """[N, d] float32 rows of NaN, infinities, signed zeros and ties, the
    minimum in the first and the last lane."""
    nan, inf = float("nan"), float("inf")
    rows = []

    def row(fill, **at):
        r = np.full(d, fill, np.float32)
        for index, value in at.items():
            r[int(index[1:]) % d] = value
        rows.append(r)

    row(inf)                                          # all +inf: 0
    row(inf, i0=5.0)
    row(inf, **{f"i{d - 1}": 7.0})                    # the last lane
    row(3.0, i5=nan, i20=nan, i2=-inf)                # the first NaN
    row(2.0, **{f"i{d - 1}": nan})
    row(1.0, i9=-0.0, i3=0.0)                         # -0.0 ties +0.0
    row(1.0, i3=-0.0, i9=0.0)
    row(0.0)
    row(-0.0, i30=0.0)
    row(4.0, i30=-inf, i31=-inf)
    row(2.0, i2=1.0, **{f"i{d - 1}": 1.0})            # ties: lowest wins
    row(5.0, **{f"i{d - 1}": 4.0})
    row(0.5, i17=-3.0, i33=-3.5, i34=-3.5)
    row(-inf, i11=nan)
    return np.stack(rows)


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [37, 64, 128])
def test_sgm_fold_wta_nan_inf_and_signed_zero(device, d, dtype):
    """Planted in a volume: an all-+inf pixel and a NaN, whose NaN runs
    down its paths.  And row by row in a one-pixel volume, where each of
    the eight traversals is one step (L = C), so the sum is the cost row
    eight times over with its NaN, infinities and zero signs: torch.
    argmin's answer, the first NaN, else the first least value."""
    left, right = _images(19, 27, d, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=d,
                                   kernel_size=2, cost_dtype=dtype)
    vol[4, 7, :] = float("inf")
    vol[2, 3, 5] = float("nan")
    vol[11, 20, 3] = -0.0
    fused, want = _wta_both(vol, left)
    summed = sgm_cuda.semiglobal_aggregate_cuda(vol, left)
    assert torch.isnan(summed).any() and torch.isinf(summed).any()
    assert torch.equal(fused, want)
    pixel = torch.zeros((1, 1), device=device)
    for row in _special_rows(d):
        one = torch.from_numpy(row).to(device).to(dtype).view(1, 1, d)
        fused, want = _wta_both(one, pixel)
        expect = torch.from_numpy(row).to(dtype).argmin()
        assert fused.item() == want.item() == expect.item(), row


def test_sgm_fold_wta_refuses_the_serial_shapes(device, launches):
    """HD at D = 256 takes the serial form, so the fused call refuses it
    and launches nothing."""
    vol = torch.zeros((1024, 1280, 256), device=device)
    left = torch.zeros((1024, 1280), device=device)
    assert not sgm_cuda.takes_wta(vol.shape)
    with pytest.raises(ValueError, match="side-by-side"):
        sgm_cuda.semiglobal_wta_cuda(vol, left)
    assert sum(launches.values()) == 0


def _kitti_pipeline():
    return cli_common.create_pipeline(
        "census", "wta", "sgm", max_disparity=128, census_window=9,
        census_height=7, kernel_size=1, adaptive_p2=False, penalty1=10,
        penalty2=120)


@pytest.mark.parametrize("cell", ["teddy", "kitti"])
def test_compiled_takes_wta_in_the_fold_and_equals_estimate(device, launches,
                                                           cell):
    """A plain-WTA graph at teddy (SSD) and at KITTI (9x7 census, constant
    P2) holds one side-by-side launch and one winner-takes-all fold, no
    volume fold and no argmin, and replays ``estimate()``'s disparities,
    which still come from the aggregated volume."""
    if cell == "teddy":
        pipe = cli_common.create_pipeline("ssd", "wta", "sgm",
                                          max_disparity=128)
        pairs = [_images(375, 450, seed, device) for seed in (1, 2)]
    else:
        pipe = _kitti_pipeline()
        pairs = [tuple(t * 255 for t in _images(375, 1242, seed, device))
                 for seed in (3, 4)]
    launches.clear()
    want = [pipe.estimate(*p).clone() for p in pairs]
    assert launches["stm_sgm_fold_f32"] == 2
    assert launches["stm_sgm_fold_wta_f32"] == 0
    assert pipe._aggregation_volume.shape == (*pairs[0][0].shape, 128)
    fn = pipe.compiled()
    got = [fn(*p) for p in pairs]
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    (graph,) = fn.graphs.values()
    assert graph.launches["stm_sgm_side_by_side_f32"] == 1
    assert graph.launches["stm_sgm_fold_wta_f32"] == 1
    assert graph.launches["stm_sgm_fold_f32"] == 0


# --------------------------------------------------------------------------
# The plain CVF paths (A.9): the card equals the CPU bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(assume_finite=True),
                                dict(subsample=2), dict(subsample=3),
                                dict(subsample=2, assume_finite=True)],
                         ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_plain_cvf_paths_on_card_equal_cpu(device, kw, dtype):
    rng = np.random.default_rng(3)
    vol = rng.random((41, 67, 20), np.float32)
    if not kw.get("assume_finite"):
        vol[rng.random(vol.shape) < 0.1] = np.inf
    guide = torch.from_numpy(rng.random((41, 67), np.float32))
    vol = torch.from_numpy(vol).to(dtype)
    cpu = cvf_ops.guided_filter_aggregate(vol, guide, radius=5, **kw)
    card = cvf_ops.guided_filter_aggregate(vol.to(device), guide.to(device),
                                           radius=5, **kw)
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sharded_cvf_on_one_card_equals_masked_single_card(device, dtype):
    left, right = _images(40, 64, 6, device)
    pipe = ShardedPipeline(make_mesh([device] * 4, n_batch=1), 16,
                           kernel_size=3, aggregation="cvf", cvf_radius=2,
                           cost_dtype=dtype)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=16,
                                   kernel_size=3,
                                   cost_dtype=getattr(torch, dtype))
    want = disp_ops.winner_takes_all(
        cvf_ops.guided_filter_aggregate(vol, left, radius=2))
    assert torch.equal(pipe.estimate(left, right), want)


# The pyramid, the video tracker and the differentiable surface (A.11,
# A.12): plain PyTorch around the SGM kernels; on the card they launch
# K2/K3 (single card) or the chunk kernel (sharded) and equal the CPU.

@pytest.mark.parametrize("levels,dtype", [(1, "float32"), (2, "float32"),
                                          (1, "bfloat16")])
def test_pyramid_on_the_card_equals_cpu(device, launches, levels, dtype):
    from stereomatch_tpu_torch.pyramid import PyramidPipeline
    left, right, _ = stereo_pair(45, 67, 32, seed=levels)    # padded
    pipe = PyramidPipeline(32, levels=levels, band_radius=5,
                           cost_dtype=dtype)
    launches.clear()
    out = pipe.estimate(left, right)
    sfx = "bf16" if dtype == "bfloat16" else "f32"
    assert out.is_cuda and out.dtype == torch.int32
    assert _sgm_launches(launches, sfx) == _sgm_counts((45, 67, 32))
    assert torch.equal(out.cpu(), pipe.estimate(left, right, device="cpu"))
    refined = pipe.estimate_refined(left, right)
    assert torch.equal(refined.cpu(),
                       pipe.estimate_refined(left, right, device="cpu"))


def test_soft_forward_equals_the_sgm_kernels(device):
    from stereomatch_tpu_torch.ops.soft import semiglobal_aggregate_diff
    left, right = (torch.from_numpy(x).to(device)
                   for x in stereo_pair(40, 56, 16, seed=3)[:2])
    flat = left.clone()
    flat[5:9] = 0.5
    vol = cost_ops.census_hamming_cost_volume(left, right, max_disparity=16)
    for p1, p2 in ((0.1, 0.2), (2.0, 4.0)):
        want = sgm_cuda.semiglobal_aggregate_cuda(vol, flat, penalty1=p1,
                                                  penalty2=p2)
        got = semiglobal_aggregate_diff(vol, flat, p1, p2)
        assert torch.equal(got, want)
    p = torch.tensor([0.1, 0.2], device=device, requires_grad=True)
    semiglobal_aggregate_diff(vol, flat, p[0], p[1]).sum().backward()
    assert torch.isfinite(p.grad).all() and (p.grad != 0).all()


@pytest.mark.parametrize("mode", ["exact", "overlap"])
def test_sharded_pyramid_launches_the_chunk_kernel(device, launches, mode):
    from stereomatch_tpu_torch.parallel import make_pyramid_sharded_estimate
    from stereomatch_tpu_torch.pyramid import PyramidPipeline
    left, right, _ = stereo_pair(80, 96, 32, seed=6)
    want = PyramidPipeline(32, levels=2, band_radius=4).estimate(left, right)
    fn = make_pyramid_sharded_estimate(
        make_mesh([device] * 5, n_batch=1), max_disparity=32, levels=2,
        band_radius=4, sgm_mode=mode, overlap=64)
    launches.clear()
    out = fn(left[None], right[None])[0]
    assert torch.equal(out, want)
    assert launches["stm_sgm_chunk_f32"] == (30 if mode == "exact" else 0)
    assert launches["stm_sgm_rows_f32"] == (0 if mode == "exact" else 30)


def test_sharded_keyframe_launches_the_chunk_kernel(device, launches):
    from stereomatch_tpu_torch.io.synthetic import stereo_sequence
    from stereomatch_tpu_torch.temporal import TemporalPipeline
    frames = stereo_sequence(40, 64, 16, 3, seed=4, motion=1)
    single = TemporalPipeline(16, keyframe_interval=2)
    sharded = TemporalPipeline(16, keyframe_interval=2,
                               mesh=make_mesh([device] * 5, n_batch=1))
    for i, (left, right, _) in enumerate(frames):
        want = single.estimate(left, right)
        launches.clear()
        out = sharded.estimate(left, right)
        assert torch.equal(out, want)
        assert launches["stm_sgm_chunk_f32"] == (30 if i % 2 == 0 else 0)
        assert torch.equal(sharded.host_disparity(), want.cpu())
    assert sharded.keyframes == single.keyframes == 2


# --------------------------------------------------------------------------
# Streaming and serving (A.13): pinned staging, one stream, graph outputs
# --------------------------------------------------------------------------

def _teddy_frames(n, seed0=40):
    """n different side-by-side teddy-size frames (375x900 uint8)."""
    frames = []
    for i in range(n):
        left, right, _ = stereo_pair(375, 450, 128, seed=seed0 + i)
        frames.append(np.concatenate([(left * 255).astype(np.uint8),
                                      (right * 255).astype(np.uint8)],
                                     axis=1))
    return frames


def _estimates(pipe, frames, device):
    return [pipe.estimate(torch.from_numpy(f[:, :450]).to(device).float(),
                          torch.from_numpy(f[:, 450:]).to(device).float()
                          ).cpu().numpy() for f in frames]


def test_stream_staging_ring_under_depth_3_at_teddy(device, launches):
    """Ten different frames, batch 1, depth 3: ten staging uses of a ring
    of four pinned buffers.  A buffer refilled while its copy still read
    it would show as another frame's disparity."""
    from stereomatch_tpu_torch.io.capture import ImageSequenceCapture
    from stereomatch_tpu_torch.stream import StreamingEstimator
    frames = _teddy_frames(10)
    est = StreamingEstimator(128, batch=1, depth=3, fetch_workers=3)
    outs = list(est.run(ImageSequenceCapture(frames)))
    (ring,) = est._rings.values()
    assert len(ring[0]) == 4 and all(s.left.is_pinned() for s in ring[0])
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm",
                                      max_disparity=128)
    for (_, disp), want in zip(outs, _estimates(pipe, frames, device)):
        assert disp.dtype == np.int32
        np.testing.assert_array_equal(disp, want)
    assert len(outs) == 10 and est.stats.batches == 10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stream_equals_pipeline_estimate_at_teddy(device, launches, dtype):
    """Batches of 4 (the last padded) replay one graph a frame; every
    frame equals the eager pipeline and a frame's launches equal those
    of an eager run of ``estimate_fn``, the frame the graph captures."""
    from stereomatch_tpu_torch.io.capture import ImageSequenceCapture
    from stereomatch_tpu_torch.stream import StreamingEstimator
    frames = _teddy_frames(6, seed0=60)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=128,
                                      volume_dtype=dtype)
    want = _estimates(pipe, frames, device)
    launches.clear()
    pipe.estimate_fn()(*(torch.from_numpy(half).to(device).float()
                         for half in (frames[0][:, :450],
                                      frames[0][:, 450:])))
    eager = collections.Counter(launches)       # the frame a graph holds
    est = StreamingEstimator(128, batch=4, cost_dtype=dtype)
    outs = list(est.run(ImageSequenceCapture(frames)))
    assert len(est._compiled.graphs) == 1
    assert est.stats.frames_run == 8
    assert est.stats.launches == collections.Counter(
        {k: v * 8 for k, v in eager.items()})
    for (_, disp), ref in zip(outs, want):
        np.testing.assert_array_equal(disp, ref)


def test_serve_concurrent_batches_against_the_graphs_output(device):
    """Sixteen clients with sixteen different frames through a batcher of
    eight workers: batches enqueue their frames and copies under one lock
    on one stream, so no replay overwrites a static output that an
    earlier batch has not copied out; every geometry has one graph,
    whatever the chunk size."""
    from stereomatch_tpu_torch.cli.serve import (_Batcher, _Engine,
                                                 build_parser)
    args = build_parser().parse_args(
        ["128", "-cm", "ssd", "--batch", "4", "--linger-ms", "2",
         "--dispatch-workers", "8"])
    batcher = _Batcher(args, _Engine(args))
    try:
        z = np.zeros((375, 450), np.uint8)
        batcher.warmup(z, z)
        est = batcher._fns[False, False]
        assert len(est._compiled.graphs) == 1
        assert len(est._rings) == 3              # chunks of 1, 2 and 4
        frames = _teddy_frames(16, seed0=80)
        results = [None] * 16
        barrier = threading.Barrier(16)

        def client(i):
            barrier.wait()
            results[i] = batcher.estimate(frames[i][:, :450],
                                          frames[i][:, 450:], refine=False)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert len(est._compiled.graphs) == 1
        pipe = cli_common.create_pipeline("ssd", "wta", "sgm",
                                          max_disparity=128)
        for got, want in zip(results, _estimates(pipe, frames, device)):
            assert got is not None and got.dtype == np.uint8
            np.testing.assert_array_equal(got.astype(np.int32), want)
        assert batcher.batches < 16
    finally:
        batcher.close()


def test_compiled_replays_from_two_streams_do_not_race(device):
    """Two threads, each on its own stream, replay one graph with
    different frames: every result equals its eager frame (the replays
    wait for each other's copy out, so none reads another's inputs)."""
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=64)
    pairs = [_images(120, 160, seed, device) for seed in (11, 12)]
    want = [pipe.estimate(*p).clone() for p in pairs]
    fn = pipe.compiled()
    fn(*pairs[0])
    torch.cuda.synchronize()
    results = {0: [], 1: []}

    def worker(i):
        stream = torch.cuda.Stream(device)
        with torch.cuda.stream(stream):
            for _ in range(20):
                results[i].append(fn(*pairs[i]))
        stream.synchronize()

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert len(fn.graphs) == 1
    for i in (0, 1):
        assert len(results[i]) == 20
        for got in results[i]:
            assert torch.equal(got, want[i])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
@pytest.mark.parametrize("offset", [0, 1, 5, 37, 53, 80])
def test_ssd_kernel_at_a_disparity_offset_bit_equal(device, launches, dtype,
                                                    offset):
    """A disparity block (the crop launch and its +inf columns) equals the
    plain version at the offset, SSD and SAD, offsets past the width
    included (no launch: every cell beyond the wedge)."""
    left, right = _images(37, 53, offset, device)
    if dtype == torch.int32:
        left, right = (left * 255).to(torch.int32), (right * 255).to(
            torch.int32)
    for absolute in (False, True):
        kw = dict(max_disparity=24, kernel_size=3, cost_dtype=dtype,
                  absolute=absolute, disparity_offset=offset)
        got = ssd_cuda.diff_cost_volume_cuda(left, right, **kw)
        want = cost_ops._diff_cost_volume(left, right, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)
    assert sum(launches.values()) == (2 if offset < 53 else 0)


def test_disparity_blocks_launch_their_kernels(device, launches):
    """ssd and census+cvf over 4 blocks on one card: one SSD launch and
    one CVF stats/filter pair a block, equal to the single-card paths."""
    from stereomatch_tpu_torch.parallel import (make_disp_mesh,
                                                make_disp_sharded_wta)
    left, right, _ = stereo_pair(64, 96, 32, seed=3)
    left, right = (torch.from_numpy(x).to(device) for x in (left, right))
    mesh = make_disp_mesh([device] * 4)
    out = make_disp_sharded_wta(mesh, max_disparity=32, kernel_size=3)(
        left, right)
    pipe = cli_common.create_pipeline("ssd", "wta", None, max_disparity=32,
                                      kernel_size=3)
    assert torch.equal(out, pipe.estimate(left, right))
    assert launches["stm_ssd_f32"] >= 4
    launches.clear()
    out = make_disp_sharded_wta(mesh, max_disparity=32, cost="census",
                                aggregation="cvf", cvf_radius=4)(left, right)
    assert launches["stm_cvf_stats_f32"] == 4
    assert launches["stm_cvf_filter_f32"] == 4
    pipe = cli_common.create_pipeline("census", "wta", "cvf",
                                      max_disparity=32, cvf_radius=4)
    assert torch.equal(out, pipe.estimate(left, right))


def test_2d_tiles_launch_their_kernels(device, launches):
    """ssd+sgm+wta over (1, 2, 2) tiles on one card at a covering
    overlap: one SSD launch and one SGM aggregation on each tile, equal
    to the single-card path."""
    from stereomatch_tpu_torch.parallel import (make_mesh_2d,
                                                make_tiled2d_estimate)
    left, right, _ = stereo_pair(64, 96, 32, seed=3)
    fn = make_tiled2d_estimate(make_mesh_2d([device] * 4, 1, 2, 2),
                               max_disparity=32, kernel_size=3, overlap=96)
    out = fn(left[None], right[None])[0]
    assert launches["stm_ssd_f32"] == 4
    # Each tile is no larger than the frame, whose form the rule picks.
    assert _sgm_launches(launches) == _sgm_counts((64, 96, 32), frames=4)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=32,
                                      kernel_size=3)
    assert torch.equal(out, pipe.estimate(left, right, device="cuda"))
