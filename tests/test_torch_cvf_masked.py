"""The port's generic guided-filter paths against the JAX package's XLA
paths (``stereomatch_tpu/ops/cvf.py``; no Pallas kernel computes them).

The same numpy volumes and guides, made from a seed, go through JAX's
``guided_filter_aggregate`` (jitted) and the port's plain version:

* the masked path (``wedge_offset=None``; wedge and scattered +inf
  cells): bit-equal to JAX's ``use_mxu=False`` lowering and, at these
  heights (H <= 96), to its default einsum lowering too, for D >= 9.
  One exception, measured: where XLA's CPU vectoriser interleaves a
  short D loop (D = 3..8 at the widths here; not at W = 20 for D = 4),
  its vector body leaves the linear model's products unfused while the
  port fuses them as XLA does elsewhere; there the bound is
  MASKED_RTOL / MASKED_ATOL (measured: 1.8e-7 absolute);
* ``assume_finite``: XLA folds the shape-only window counts into
  constants and multiplies by their reciprocals; the port computes the
  same forms, bit-equal at ``use_mxu=False`` (the default lowering
  computes the counts differently: MASKED_RTOL / MASKED_ATOL there);
* the fast guided filter (``subsample`` 2 and 3): XLA's CPU builds the
  resize weights and contracts them with vectorised, reassociated sums
  whose order changes with the sizes; the port takes the weights'
  formula one rounding an operation and its taps in index order:
  within FAST_RTOL / FAST_ATOL (measured up to 5.5e-5 relative, 1.1e-5
  absolute), identical +inf placement; bf16 results within one bf16
  unit in the last place (2^-7 relative);
* ``guided_filter_from_padded`` (the sharded body): bit-equal to JAX's,
  jitted, and to the masked path of the whole image.

bf16 volumes cross as their uint16 patterns.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

from stereomatch_tpu.aggregation import CostFilter as JaxCostFilter
from stereomatch_tpu.ops.cvf import guided_filter_aggregate as jax_cvf
from stereomatch_tpu.ops.cvf import guided_filter_from_padded as jax_padded
from stereomatch_tpu_torch.aggregation import CostFilter
from stereomatch_tpu_torch.ops import cvf as port
from stereomatch_tpu_torch.ops import cvf_cuda
from stereomatch_tpu_torch.pipeline import tensor_from_numpy

from .torch_threads import one_torch_thread  # noqa: F401

MASKED_RTOL, MASKED_ATOL = 1e-5, 1e-6
FAST_RTOL, FAST_ATOL = 2e-4, 2e-5
BF16_RTOL = 2.0 ** -7

# (H, W, D, r): D >= 9, where XLA's CPU code fuses throughout.
SHAPES = [(20, 30, 12, 3), (17, 25, 9, 2), (33, 41, 16, 8), (12, 40, 16, 1),
          (96, 64, 10, 4), (9, 13, 24, 6)]
# Short D loops that XLA's CPU vectoriser interleaves.
INTERLEAVED = [(17, 25, 5, 2), (17, 25, 8, 2), (12, 40, 4, 1),
               (12, 40, 3, 1)]
FAST = [(20, 30, 12, 4, 2), (24, 36, 9, 6, 3), (33, 41, 16, 8, 2),
        (48, 64, 16, 4, 2), (40, 40, 10, 8, 4)]


def _case(h, w, d, holes=True):
    rng = np.random.default_rng(7 * h + w)
    vol = rng.random((h, w, d), np.float32)
    x, dd = np.meshgrid(np.arange(w), np.arange(d), indexing="ij")
    vol[:, x < dd] = np.inf
    if holes:
        vol[rng.random(vol.shape) < 0.05] = np.inf
    return vol, rng.random((h, w), np.float32)


def _finite(vol):
    return np.where(np.isinf(vol), np.float32(2.5), vol).astype(np.float32)


def _port(vol, g, **kw):
    return port.guided_filter_aggregate(tensor_from_numpy(vol),
                                        torch.from_numpy(g), **kw)


def _assert_close(got, ref, rtol, atol):
    assert np.array_equal(np.isinf(got), np.isinf(ref))
    m = np.isfinite(ref)
    np.testing.assert_allclose(got[m], ref[m], rtol=rtol, atol=atol)


@pytest.mark.parametrize("h,w,d,r", SHAPES)
@pytest.mark.parametrize("holes", [False, True], ids=["wedge", "holes"])
def test_masked_bit_equal_to_xla(h, w, d, r, holes):
    vol, g = _case(h, w, d, holes)
    got = _port(vol, g, radius=r).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_cvf(vol, g, radius=r, use_mxu=False)))
    np.testing.assert_array_equal(got, np.asarray(jax_cvf(vol, g, radius=r)))


@pytest.mark.parametrize("h,w,d,r", INTERLEAVED)
def test_masked_where_xla_interleaves_the_d_loop(h, w, d, r):
    vol, g = _case(h, w, d)
    _assert_close(_port(vol, g, radius=r).numpy(),
                  np.asarray(jax_cvf(vol, g, radius=r, use_mxu=False)),
                  MASKED_RTOL, MASKED_ATOL)


def test_masked_keeps_every_window_finite():
    """An all-+inf column band: its windows hold no valid cell (count
    floored at 1), their cells stay +inf and nothing turns NaN."""
    vol, g = _case(16, 20, 12, holes=False)
    vol[:, 5:9] = np.inf
    got = _port(vol, g, radius=1).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(
        got, np.asarray(jax_cvf(vol, g, radius=1, use_mxu=False)))


@pytest.mark.parametrize("h,w,d,r", SHAPES + INTERLEAVED)
def test_assume_finite_bit_equal_to_xla(h, w, d, r):
    vol, g = _case(h, w, d)
    vol = _finite(vol)
    got = _port(vol, g, radius=r, assume_finite=True).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax_cvf(vol, g, radius=r, assume_finite=True,
                                use_mxu=False)))
    _assert_close(got, np.asarray(jax_cvf(vol, g, radius=r,
                                          assume_finite=True)),
                  MASKED_RTOL, MASKED_ATOL)


def test_assume_finite_equals_masked_on_a_finite_volume():
    vol, g = _case(20, 30, 12)
    vol = torch.from_numpy(_finite(vol))
    g = torch.from_numpy(g)
    np.testing.assert_allclose(
        port.guided_filter_aggregate(vol, g, radius=3,
                                     assume_finite=True).numpy(),
        port.guided_filter_aggregate(vol, g, radius=3).numpy(),
        rtol=MASKED_RTOL, atol=MASKED_ATOL)


@pytest.mark.parametrize("h,w,d,r,s", FAST)
@pytest.mark.parametrize("assume_finite", [False, True],
                         ids=["masked", "finite"])
def test_fast_guided_filter_within_bound_of_xla(h, w, d, r, s,
                                                assume_finite):
    vol, g = _case(h, w, d, holes=False)
    if assume_finite:
        vol = _finite(vol)
    kw = dict(radius=r, subsample=s, assume_finite=assume_finite)
    got = _port(vol, g, **kw).numpy()
    ref = np.asarray(jax_cvf(vol, g, **kw))
    _assert_close(got, ref, FAST_RTOL, FAST_ATOL)
    assert (got.argmin(axis=2) == ref.argmin(axis=2)).all()


@pytest.mark.parametrize("h,w,d,r", SHAPES[:3])
@pytest.mark.parametrize("subsample", [1, 2, 3])
def test_bf16_volumes(h, w, d, r, subsample):
    """bf16 storage, float32 statistics, q rounded once: the masked path
    bit for bit (uint16 patterns), the fast one within a bf16 unit."""
    vol, g = _case(h, w, d)
    vb = np.asarray(jnp.asarray(vol).astype(jnp.bfloat16))
    ref = np.asarray(jax_cvf(vb, g, radius=r, subsample=subsample,
                             use_mxu=False))
    got = _port(vb, g, radius=r, subsample=subsample)
    assert got.dtype == torch.bfloat16
    if subsample == 1:
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            ref.view(np.uint16))
    else:
        _assert_close(got.float().numpy(), ref.astype(np.float32),
                      BF16_RTOL, 0.0)


@pytest.mark.parametrize("h,w,d,r", [(20, 30, 12, 3), (33, 41, 16, 8),
                                     (40, 36, 9, 2)])
def test_from_padded_equals_xla_and_the_whole_image(h, w, d, r):
    """Halo rows of +inf around the tile: the crop equals JAX's jitted
    padded body and the port's masked filter of the unpadded volume."""
    vol, g = _case(h, w, d)
    pad = 2 * r
    vp = np.pad(vol, ((pad, pad), (0, 0), (0, 0)), constant_values=np.inf)
    gp = np.pad(g, ((pad, pad), (0, 0)))
    got = port.guided_filter_from_padded(
        torch.from_numpy(vp), torch.from_numpy(gp), pad, pad,
        radius=r).numpy()
    ref = jax.jit(functools.partial(jax_padded, pad_before=pad,
                                    pad_after=pad, radius=r,
                                    use_mxu=False))(vp, gp)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, _port(vol, g, radius=r).numpy())


# Size pairs whose weights XLA's CPU builds in the formula's own order;
# 375 -> 187 and 1280 -> 426 (teddy and HD at s = 2 and 3) sum the
# columns in another, within one unit in the last place.
WEIGHT_SIZES = [(20, 10), (21, 10), (450, 225), (187, 375), (225, 450),
                (30, 10), (31, 10), (1024, 512), (512, 1024), (17, 5),
                (5, 17), (13, 4), (4, 13), (37, 9), (9, 37)]


@pytest.mark.parametrize("m,n", WEIGHT_SIZES + [(375, 187), (1280, 426)])
def test_resize_weights_equal_compute_weight_mat(m, n):
    ref = np.asarray(compute_weight_mat(m, n, n / m, 0.0,
                                        _fill_triangle_kernel, True))
    got = port.resize_weights(m, n)
    assert got.dtype == np.float32 and got.shape == (m, n)
    if (m, n) in WEIGHT_SIZES:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=6e-8)


def test_resize_taps_cover_the_weights():
    """The banded taps hold every nonzero weight, in index order."""
    for m, n in ((375, 187), (187, 375), (40, 13)):
        index, weight = port.resize_taps(m, n, "cpu")
        dense = np.zeros((m, n), np.float32)
        for t in range(index.shape[0]):
            np.add.at(dense, (index[t].numpy(), np.arange(n)),
                      weight[t].numpy())
        np.testing.assert_array_equal(dense, port.resize_weights(m, n))


def test_cost_filter_class_runs_every_path_as_jax():
    vol, g = _case(20, 30, 12)
    t_vol, t_g = torch.from_numpy(vol), torch.from_numpy(g)
    for kw in (dict(radius=3), dict(radius=4, subsample=2)):
        ref = np.asarray(JaxCostFilter(**kw)(vol, g))
        got = CostFilter(**kw, backend="cuda")(t_vol, t_g).numpy()
        _assert_close(got, ref, FAST_RTOL, FAST_ATOL)
    with pytest.raises(ValueError, match="wedge path only"):
        cvf_cuda.guided_filter_aggregate_cuda(t_vol, t_g, wedge_offset=None)


# --------------------------------------------------------------------------
# Teddy: the JAX package's default lowering (the H box an einsum where
# H <= 512) against the port's sequential sums
# --------------------------------------------------------------------------

def teddy_differences(subsamples=(2, 4)) -> dict:
    """At the golden teddy scene (375x450, D=128, the census volume, r=8):
    for the masked path, ``assume_finite`` (the +inf wedge set to 25) and
    the fast guided filter, how far the port is from the JAX package's
    default lowering: cells that differ, the largest absolute difference
    over finite cells beside the largest finite value, and disparity
    (WTA) pixels that differ."""
    from stereomatch_tpu_torch.ops.cost import census_hamming_cost_volume
    from stereomatch_tpu_torch.io.synthetic import stereo_pair

    left, right, _ = stereo_pair(375, 450, 128, seed=2026)
    vol = census_hamming_cost_volume(torch.from_numpy(left),
                                     torch.from_numpy(right),
                                     max_disparity=128).numpy()
    out = {}
    cases = [("masked", vol, {}),
             ("assume_finite", _finite_at(vol, 25.0), {"assume_finite": True})]
    cases += [(f"fast_s{s}", vol, {"subsample": s}) for s in subsamples]
    for name, v, kw in cases:
        ref = np.asarray(jax_cvf(v, left, radius=8, **kw))
        got = _port(v, left, radius=8, **kw).numpy()
        assert np.array_equal(np.isinf(got), np.isinf(ref))
        m = np.isfinite(ref)
        diff = np.abs(got[m] - ref[m])
        out[name] = {
            "cells_differing": int((got != ref).sum()), "cells": int(ref.size),
            "max_abs": float(diff.max()),
            "max_finite": float(np.abs(ref[m]).max()),
            "disparity_pixels_differing": int(
                (got.argmin(axis=2) != ref.argmin(axis=2)).sum())}
    return out


def _finite_at(vol, value):
    return np.where(np.isinf(vol), np.float32(value), vol).astype(np.float32)


# Largest absolute difference at teddy, on volumes of Hamming distances
# up to 24: measured 1.1e-5 (masked), 2.1e-5 (assume_finite), 6.8e-5
# (fast, s = 2), with 0 disparity pixels differing.
TEDDY_ATOL = {"masked": 5e-5, "assume_finite": 5e-5, "fast_s2": 5e-4}


def test_teddy_default_lowering_within_bounds():
    """The measured distances (``python -m tests.test_torch_cvf_masked``
    prints them) stay within TEDDY_ATOL, and no disparity moves."""
    found = teddy_differences(subsamples=(2,))
    for name, atol in TEDDY_ATOL.items():
        assert found[name]["max_abs"] <= atol, (name, found[name])
        assert found[name]["disparity_pixels_differing"] == 0, name


if __name__ == "__main__":
    import json
    print(json.dumps(teddy_differences(), indent=1))
