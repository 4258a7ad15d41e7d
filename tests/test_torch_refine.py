"""The port's post-processing (``stereomatch_tpu_torch/ops/refine.py``)
against the JAX package's ``ops/refine.py`` on the CPU.

Inputs are made from a numpy seed: the synthetic scenes at 24x40 D=16
and 37x53 D=24, their SSD -> SGM volumes and WTA disparities (built by
the JAX package's XLA ops), and random volumes and maps.  The JAX side
runs as ``tests/test_refine.py`` runs it (its jitted functions on the
CPU).  Every function is held bit for bit: the integer outputs, the
sub-pixel offsets, PKRN, the right-view volume, and the two stages that
weigh by ``exp`` (the weighted median, the fast global smoother), whose
``exp``, fused multiply-adds and folded lambda the port reproduces
(``utils/numeric.py``).  The weighted median is also held the way a
last-place difference of the weights would show: the weights within 2
ulp of XLA's, and no bin that differs unless its cumulative weight lies
within that rounding of half the total (0 such pixels here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu.io.synthetic import stereo_pair
from stereomatch_tpu.ops import refine as jax_refine
from stereomatch_tpu.ops.aggregation import semiglobal_aggregate
from stereomatch_tpu.ops.cost import ssd_cost_volume
from stereomatch_tpu.ops.disparity import winner_takes_all
from stereomatch_tpu_torch.ops import refine
from stereomatch_tpu_torch.utils.numeric import exp_f32

from .torch_threads import one_torch_thread  # noqa: F401

SCENES = [(24, 40, 16, 1), (37, 53, 24, 2), (37, 53, 24, 7)]


def _t(array) -> torch.Tensor:
    return torch.from_numpy(np.array(array))


def _equal(jax_out, port_out):
    ref = np.asarray(jax_out)
    out = port_out.numpy()
    assert out.dtype == ref.dtype and out.shape == ref.shape
    np.testing.assert_array_equal(out, ref)


@pytest.fixture(scope="module", params=SCENES, ids=str)
def scene(request):
    """(left, volume, disparity, right disparity, LR mask, max_disparity)
    of a synthetic scene, from the JAX package's ops."""
    h, w, d, seed = request.param
    left, right, _ = stereo_pair(h, w, d, seed=seed)
    vol = np.asarray(semiglobal_aggregate(
        ssd_cost_volume(left, right, max_disparity=d, kernel_size=3), left))
    disp = np.asarray(winner_takes_all(vol))
    disp_r = np.asarray(jax_refine.right_disparity_from_volume(vol))
    mask = np.asarray(jax_refine.left_right_consistency(
        disp, disp_r, 1, max_disparity=d))
    return left, vol, disp, disp_r, mask, d


def test_subpixel_refine(scene):
    _, vol, disp, *_ = scene
    _equal(jax_refine.subpixel_refine(vol, disp),
           refine.subpixel_refine(_t(vol), _t(disp)))


def test_subpixel_refine_at_the_borders_and_past_them():
    """d = 0, D - 1 and out-of-range d keep their value; a volume with
    +inf cells (SSD's d > x) and a flat parabola too."""
    rng = np.random.default_rng(3)
    vol = rng.random((6, 9, 8)).astype(np.float32)
    vol[:, :3, 5:] = np.inf
    vol[0, 0] = 1.0
    disp = rng.integers(-2, 10, (6, 9)).astype(np.int32)
    _equal(jax_refine.subpixel_refine(vol, disp),
           refine.subpixel_refine(_t(vol), _t(disp)))


def test_median_filter_3x3(scene):
    disp = scene[2]
    _equal(jax_refine.median_filter_3x3(disp),
           refine.median_filter_3x3(_t(disp)))
    filled = np.asarray(jax_refine.fill_inconsistent(disp, scene[4]))
    _equal(jax_refine.median_filter_3x3(filled),
           refine.median_filter_3x3(_t(filled)))


@pytest.mark.parametrize("max_diff,bounded", [(1, True), (0, False)])
def test_left_right_consistency(scene, max_diff, bounded):
    _, _, disp, disp_r, _, d = scene
    kw = dict(max_disparity=d) if bounded else {}
    _equal(jax_refine.left_right_consistency(disp, disp_r, max_diff, **kw),
           refine.left_right_consistency(_t(disp), _t(disp_r), max_diff,
                                         **kw))


def test_consistency_from_padded_clamps_as_dynamic_slice():
    """A pad narrower than the planes and disparities outside [0,
    n_planes): the start clamps into the padded row, as JAX's
    dynamic_slice clamps it."""
    rng = np.random.default_rng(4)
    d_l = rng.integers(-3, 14, (2, 5, 11)).astype(np.int32)
    padded = rng.integers(0, 12, (2, 5, 15)).astype(np.int32)
    kw = dict(pad=4, n_planes=12, max_diff=1)
    _equal(jax_refine.consistency_from_padded(d_l, padded, **kw),
           refine.consistency_from_padded(_t(d_l), _t(padded), **kw))


def test_fill_inconsistent_and_propagate_last_valid(scene):
    _, _, disp, _, mask, _ = scene
    _equal(jax_refine.fill_inconsistent(disp, mask),
           refine.fill_inconsistent(_t(disp), _t(mask)))
    vals = disp.astype(np.float32)
    _equal(jax_refine.propagate_last_valid(vals, mask),
           refine.propagate_last_valid(_t(vals), _t(mask)))


def test_fill_keeps_rows_without_a_consistent_pixel():
    disp = np.arange(12, dtype=np.int32).reshape(3, 4)
    mask = np.array([[0, 0, 0, 0], [0, 1, 0, 0], [1, 0, 0, 1]], bool)
    _equal(jax_refine.fill_inconsistent(disp, mask),
           refine.fill_inconsistent(_t(disp), _t(mask)))


def test_confidence_pkrn(scene):
    vol = scene[1]
    _equal(jax_refine.confidence_pkrn(vol), refine.confidence_pkrn(_t(vol)))


def test_confidence_pkrn_ties_and_non_finite_lanes():
    rng = np.random.default_rng(5)
    vol = rng.integers(0, 4, (5, 7, 6)).astype(np.float32)
    vol[0, :, 1:] = np.inf                      # one finite hypothesis
    vol[1, :] = np.inf                          # none
    vol[2, :, 2] = np.nan
    _equal(jax_refine.confidence_pkrn(vol), refine.confidence_pkrn(_t(vol)))


@pytest.mark.parametrize("volume", ["scene", "bf16"])
def test_right_volume_and_disparity(scene, volume):
    vol = scene[1]
    if volume == "bf16":
        vol = np.asarray(jnp.asarray(vol, jnp.bfloat16))
        port = _t(vol.view(np.int16)).view(torch.bfloat16)
        out = refine.right_volume_from_left(port)
        assert out.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            out.view(torch.int16).numpy(),
            np.asarray(jax_refine.right_volume_from_left(vol)).view(np.int16))
        return
    _equal(jax_refine.right_volume_from_left(vol),
           refine.right_volume_from_left(_t(vol)))
    _equal(jax_refine.right_disparity_from_volume(vol),
           refine.right_disparity_from_volume(_t(vol)))


def test_right_volume_from_padded_with_real_neighbours():
    """A volume extended by D - 1 real columns (the 2-D mesh's case) and
    a leading batch axis."""
    rng = np.random.default_rng(6)
    padded = rng.random((2, 4, 13 + 5, 6)).astype(np.float32)
    _equal(jax_refine.right_volume_from_padded(padded, width=13),
           refine.right_volume_from_padded(_t(padded), width=13))


def test_right_disparity_mirrors_the_pipeline(scene):
    left = scene[0]
    right = np.roll(left, -2, axis=1)

    def jax_fn(a, b):
        return winner_takes_all(ssd_cost_volume(a, b, max_disparity=8,
                                                kernel_size=2))

    def port_fn(a, b):
        from stereomatch_tpu_torch.ops import cost, disparity
        return disparity.winner_takes_all(cost.ssd_cost_volume(
            a, b, max_disparity=8, kernel_size=2))

    _equal(jax_refine.right_disparity(jax_fn, left, right),
           refine.right_disparity(port_fn, _t(left), _t(right)))


def _jax_wmf_weights(left, window, sigma):
    """The weights of each tap, in tap order, as the JAX package's
    ``_wmf_from_padded`` forms them."""
    r = window // 2
    h, w = left.shape
    g_pad = jnp.pad(jnp.asarray(left), r, constant_values=np.float32(np.inf))
    inv = np.float32(-0.5) / jnp.asarray(sigma, jnp.float32) ** 2
    taps = []
    for dy in range(window):
        for dx in range(window):
            gq = g_pad[dy:dy + h, dx:dx + w]
            wt = jnp.exp((gq - left) ** 2 * inv)
            taps.append(np.asarray(jnp.where(jnp.isfinite(gq), wt, 0.0)))
    return np.stack(taps, axis=-1)


@pytest.mark.parametrize("window,sigma", [(5, 0.1), (3, 0.05), (7, 10.0)])
def test_weighted_median_filter(scene, window, sigma):
    left, _, disp, _, mask, d = scene
    filled = np.asarray(jax_refine.fill_inconsistent(disp, mask))
    for x in (disp, filled):
        ref = np.asarray(jax_refine.weighted_median_filter(
            x, left, window=window, sigma=sigma, n_bins=d))
        out = refine.weighted_median_filter(_t(x), _t(left), window=window,
                                            sigma=sigma, n_bins=d)
        # Weights within 2 ulp of XLA's (0 with the port's exp).
        r = window // 2
        g = _t(left)
        g_pad = torch.nn.functional.pad(g, (r, r, r, r),
                                        value=float("inf"))
        port_w = refine.wmf_weights(g_pad, g, window=window,
                                    sigma=sigma).numpy()
        jax_w = _jax_wmf_weights(left, window, sigma)
        ulp = np.abs(port_w.view(np.int32).astype(np.int64)
                     - jax_w.view(np.int32).astype(np.int64))
        assert ulp.max() <= 2
        differ = np.argwhere(out.numpy() != ref)
        # A differing bin is allowed only where the cumulative weight lies
        # within the weights' rounding of half the total: none here.
        assert len(differ) == 0, differ[:5]
        assert out.numpy().dtype == ref.dtype


def test_exp_f32_equals_xla_exp():
    """The port's float32 exp against XLA's on the CPU over the arguments
    the filters pass (<= 0) and beyond, inf and NaN included."""
    rng = np.random.default_rng(8)
    x = np.concatenate([-rng.random(200_000) * 90, rng.random(2_000) * 88,
                        [0.0, -0.0, np.inf, -np.inf, np.nan, -1e-30,
                         -87.6, -88.0, -200.0]]).astype(np.float32)
    ref = np.asarray(jnp.exp(jnp.asarray(x)))
    out = exp_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_fgs_pieces_bit_equal():
    """The lambda schedule (as XLA folds it under jit), the system, the
    Thomas sweeps with seeds, and a pass, on random inputs."""
    rng = np.random.default_rng(9)
    u = (rng.random((6, 17)) * 16).astype(np.float32)
    c = np.maximum(rng.random((6, 17)), 1e-3).astype(np.float32)
    a = np.exp(-rng.random((6, 16)) * 3).astype(np.float32)
    for lam_in, total in ((16.0, 3), (128.0, 3), (3.7, 2)):
        for t in range(1, total + 1):
            ref = np.asarray(jax.jit(
                lambda x, t=t, total=total:
                jax_refine._fgs_lambda_schedule(x, total, t))(
                    jnp.float32(lam_in)))
            out = refine._fgs_lambda_schedule(torch.tensor(lam_in), total, t)
            assert out.dtype == torch.float32 and out.numpy() == ref
    lam = np.float32(6.0952387)
    ref = np.asarray(jax.jit(jax_refine._fgs_pass)(u, c, a, lam))
    out = refine._fgs_pass(_t(u), _t(c), _t(a), torch.tensor(lam))
    np.testing.assert_array_equal(out.numpy(), ref)
    cp0 = rng.random(6).astype(np.float32)
    dp0 = rng.random(6).astype(np.float32)
    zero = np.zeros((6, 1), np.float32)
    a_r, a_l = np.concatenate([a, zero], 1), np.concatenate([zero, a], 1)
    system = jax.jit(jax_refine._fgs_system)(u, c, a_l, a_r, lam)
    port_system = refine._fgs_system(_t(u), _t(c), _t(a_l), _t(a_r),
                                     torch.tensor(lam))
    for x, y in zip(system, port_system):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    fwd = jax.jit(jax_refine._thomas_forward)(*system, cp0, dp0)
    port_fwd = refine._thomas_forward(*port_system, _t(cp0), _t(dp0))
    for x, y in zip(fwd, port_fwd):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    np.testing.assert_array_equal(
        refine._thomas_backward(*port_fwd, _t(dp0)).numpy(),
        np.asarray(jax.jit(jax_refine._thomas_backward)(*fwd, dp0)))
    conf = rng.random((6, 17)).astype(np.float32) * 0.01
    np.testing.assert_array_equal(
        refine._fgs_confidence(_t(u), _t(conf)).numpy(),
        np.asarray(jax_refine._fgs_confidence(u, conf)))


@pytest.mark.parametrize("lam,sigma,weighted",
                         [(16.0, 0.08, False), (128.0, 8.0, False),
                          (16.0, 0.08, True), (128.0, 0.08, True)])
def test_fgs_smooth(scene, lam, sigma, weighted):
    """Within 1e-5 in disparity units; measured 0 (the port reproduces
    XLA's exp, contractions and folded lambda)."""
    left, _, disp, _, mask, _ = scene
    conf = mask.astype(np.float32) if weighted else None
    ref = np.asarray(jax_refine.fgs_smooth(
        disp.astype(np.float32), left, lam=lam, sigma_color=sigma,
        confidence=conf))
    out = refine.fgs_smooth(_t(disp).float(), _t(left), lam=lam,
                            sigma_color=sigma,
                            confidence=None if conf is None else _t(conf))
    assert out.dtype == torch.float32
    err = float(np.abs(out.numpy() - ref).max())
    assert err <= 1e-5
    assert err == 0.0


@pytest.mark.parametrize("window,max_diff,min_frac",
                         [(9, 1.0, 0.25), (5, 0.0, 0.5), (3, 2.0, 0.9)])
def test_speckle_mask_and_filter(scene, window, max_diff, min_frac):
    _, _, disp, _, mask, _ = scene
    speckled = disp.copy()
    speckled[::7, ::5] += 9
    kw = dict(max_diff=max_diff, window=window, min_frac=min_frac)
    _equal(jax_refine.speckle_mask(speckled, **kw),
           refine.speckle_mask(_t(speckled), **kw))
    for fill in ("zero", "background"):
        _equal(jax_refine.filter_speckles(speckled, fill=fill, **kw),
               refine.filter_speckles(_t(speckled), fill=fill, **kw))
    with pytest.raises(ValueError, match="fill mode"):
        refine.filter_speckles(_t(speckled), fill="mean")


def test_windowed_support_on_halo_rows():
    """The shared support core on a NaN-edged plane with real halo rows."""
    rng = np.random.default_rng(10)
    padded = rng.integers(0, 4, (9 + 4, 12 + 4)).astype(np.float32)
    padded[:, :2] = np.nan
    center = padded[2:-2, 2:-2].copy()
    kw = dict(max_diff=1.0, window=5, min_frac=0.4)
    _equal(jax_refine._windowed_support(padded, center, **kw),
           refine._windowed_support(_t(padded), _t(center), **kw))
