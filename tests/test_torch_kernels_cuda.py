"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.

Marked ``cuda``: each test needs an NVIDIA GPU and nvcc and skips, with
its reason, where there is none.  On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q

The kernels keep their plain versions' association and round every
operation on its own, so every comparison is bit-equality.  This file
imports nothing of JAX, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from stereomatch_tpu_torch import cli_common
from stereomatch_tpu_torch.io.synthetic import stereo_pair
from stereomatch_tpu_torch.ops import aggregation as agg_ops
from stereomatch_tpu_torch.ops import cost as cost_ops
from stereomatch_tpu_torch.ops import sgm_cuda, ssd_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _images(h, w, seed, device):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.random((h, w), np.float32)).to(device),
            torch.from_numpy(rng.random((h, w), np.float32)).to(device))


SHAPES = [(37, 53, 24, 3), (5, 12, 16, 7), (1, 10, 4, 2), (64, 96, 40, 5),
          (20, 31, 300, 2)]


@pytest.mark.parametrize("absolute", [False, True], ids=["ssd", "sad"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
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


@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.int16])
def test_ssd_kernel_int32_chain_exact(device, in_dtype):
    left, right = _images(21, 33, 3, device)
    scale = 255 if in_dtype == torch.uint8 else 30000
    left8, right8 = (left * scale).to(in_dtype), (right * scale).to(in_dtype)
    kw = dict(max_disparity=16, kernel_size=5, cost_dtype=torch.int32)
    ref = cost_ops.ssd_cost_volume(left8, right8, **kw)
    out = ssd_cuda.diff_cost_volume_cuda(left8, right8, absolute=False,
                                         **kw)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_sgm_kernels_bit_equal(device, shape):
    h, w, d, k = shape
    left, right = _images(h, w, 2 * h + w, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=d,
                                   kernel_size=k)
    ref = agg_ops.semiglobal_aggregate(vol, left, penalty1=0.2, penalty2=0.9)
    out = sgm_cuda.semiglobal_aggregate_cuda(vol, left, penalty1=0.2,
                                             penalty2=0.9)
    assert torch.equal(out, ref)


def test_sgm_kernel_nan_and_inf_like_plain(device):
    """A pixel whose costs are all +inf gives inf - inf in the band; the
    kernels must produce what the plain version produces, NaN included."""
    left, right = _images(9, 14, 1, device)
    vol = cost_ops.ssd_cost_volume(left, right, max_disparity=6,
                                   kernel_size=2)
    vol[4, 7, :] = float("inf")
    ref = agg_ops.semiglobal_aggregate(vol, left)
    out = sgm_cuda.semiglobal_aggregate_cuda(vol, left)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    keep = ~torch.isnan(ref)
    assert torch.equal(out[keep], ref[keep])


def test_main_path_goes_through_kernels(device, monkeypatch):
    monkeypatch.setattr(ssd_cuda, "LAUNCHES", 0)
    monkeypatch.setattr(sgm_cuda, "ROW_LAUNCHES", 0)
    monkeypatch.setattr(sgm_cuda, "HORIZONTAL_LAUNCHES", 0)
    left, right, _ = stereo_pair(48, 80, 16, seed=7)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=16)
    disp = pipe.estimate(left, right, device=device)
    assert disp.is_cuda
    assert ssd_cuda.LAUNCHES == 1
    assert sgm_cuda.ROW_LAUNCHES == 6 and sgm_cuda.HORIZONTAL_LAUNCHES == 2
    plain = pipe.estimate(left, right)            # numpy -> the CPU
    assert torch.equal(disp.cpu(), plain)


def test_wta_ties_go_to_lower_disparity_on_cuda(device):
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 2, (32, 48, 64)).astype(np.float32)
    out = cli_common.DISPARITY_METHODS["wta"]()(torch.from_numpy(vol).to(device))
    np.testing.assert_array_equal(out.cpu().numpy(), np.argmin(vol, axis=2))
