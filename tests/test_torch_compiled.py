"""``Pipeline.compiled()`` of the port against the JAX package's.

JAX's ``compiled()`` is one XLA program a frame (a ``jax.jit`` of
``estimate_fn``); XLA may fuse across the stage boundaries, so it could
differ from JAX's ``estimate`` in the last place.  On the CPU the port's
``compiled()`` runs ``estimate_fn`` eagerly (the CPU has no CUDA graphs),
and each registry path's disparities are held equal to both JAX's
``compiled()`` and JAX's ``estimate`` at 24x40, D=8: all of them agree
there (0 pixels differ on every path).  On the card the port's
``compiled()`` replays a CUDA graph of the eager frame, equal to it by
construction (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""

import inspect
import itertools

import numpy as np
import pytest
import torch

from stereomatch_tpu import cli_common as jax_cli
from stereomatch_tpu_torch import Pipeline, cli_common
from stereomatch_tpu_torch.io.synthetic import stereo_pair
from stereomatch_tpu_torch.pipeline import CompiledPipeline
from stereomatch_tpu_torch.utils import validation

from .torch_threads import one_torch_thread  # noqa: F401

D = 8
COSTS = ("ssd", "sad", "census", "birchfield", "ncc", "ssd-texture")
# Every single-card path create_pipeline builds: each cost, aggregation
# and reducer in float32; bf16 volumes; the int32 chain without
# aggregation; the fast guided filter.
PATHS = ([dict(cost_method=c, aggr_method=a, disp_method=r)
          for c, a, r in itertools.product(COSTS, (None, "sgm", "cvf"),
                                           ("wta", "dyn"))]
         + [dict(cost_method=c, aggr_method=a, disp_method=r,
                 volume_dtype="bfloat16")
            for c, a, r in (("ssd", "sgm", "wta"), ("ssd", "sgm", "dyn"),
                            ("census", "cvf", "wta"), ("ncc", None, "wta"))]
         + [dict(cost_method="ssd", aggr_method=None, disp_method=r,
                 volume_dtype="int32") for r in ("wta", "dyn")]
         + [dict(cost_method="census", aggr_method="cvf", disp_method="wta",
                 cvf_subsample=2)])


def _id(kw):
    return "-".join(str(v) for v in kw.values())


@pytest.fixture(scope="module")
def pair():
    left, right, _ = stereo_pair(24, 40, D, seed=5)
    return left, right


@pytest.mark.parametrize("kw", PATHS, ids=_id)
def test_compiled_equals_jax_compiled_and_estimate(pair, kw):
    left, right = pair
    kw = dict(kw, max_disparity=D, cvf_radius=3)
    jax_pipe = jax_cli.create_pipeline(**kw)
    jax_estimate = np.asarray(jax_pipe.estimate(left, right))
    jax_compiled = np.asarray(jax_pipe.compiled()(left, right))
    pipe = cli_common.create_pipeline(device="cpu", **kw)
    fn = pipe.compiled()
    got = fn(left, right)
    assert got.dtype == torch.int32 and tuple(got.shape) == left.shape
    np.testing.assert_array_equal(got.numpy(), jax_compiled)
    np.testing.assert_array_equal(got.numpy(), jax_estimate)
    assert torch.equal(got, pipe.estimate(left, right))
    assert fn.graphs == {}          # the CPU runs the frame eagerly


def test_signature_and_donate_match_jax():
    port_sig = inspect.signature(Pipeline.compiled)
    jax_sig = inspect.signature(jax_cli.Pipeline.compiled)
    assert list(port_sig.parameters) == list(jax_sig.parameters)
    assert port_sig.parameters["donate"].default is True


def test_donate_changes_nothing_and_results_are_fresh(pair):
    """``donate`` is accepted and changes no result; each call returns a
    tensor of its own, which a later call leaves as it was."""
    left, right = pair
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=D,
                                      device="cpu")
    first = pipe.compiled(donate=True)
    second = pipe.compiled(donate=False)
    assert isinstance(first, CompiledPipeline)
    a = first(left, right)
    kept = a.clone()
    b = second(torch.from_numpy(left), torch.from_numpy(right))
    other = first(right, left)
    assert torch.equal(a, b) and torch.equal(a, kept)
    assert a.data_ptr() != other.data_ptr()


@pytest.mark.parametrize("make_pair", [
    lambda l, r: (l, r[:, :-1]),
    lambda l, r: (l[None], r[None]),
    lambda l, r: (l[:, :, None], r)],
    ids=["shape", "rank", "mixed-rank"])
@pytest.mark.parametrize("cost", ["ssd", "census"])
def test_invalid_pairs_raise_as_jax_does(pair, make_pair, cost):
    """The pair is validated as ``estimate`` validates it: a shape or
    rank mismatch raises ``ShapeError``, a ValueError, as JAX's
    ``compiled()`` raises a ValueError while it traces."""
    left, right = make_pair(*pair)
    pipe = cli_common.create_pipeline(cost, "wta", "sgm", max_disparity=D,
                                      device="cpu")
    jax_pipe = jax_cli.create_pipeline(cost, "wta", "sgm", max_disparity=D)
    with pytest.raises(validation.ShapeError):
        pipe.compiled()(left, right)
    with pytest.raises(ValueError):
        jax_pipe.compiled()(left, right)
