"""The port's Birchfield, ZNCC and SSD-over-textures costs against the
JAX package's on the CPU.

The same numpy scenes (``tests/conftest.py::synthetic_stereo_pair``,
seeded) go through the JAX function (its XLA path: these costs have no
Pallas kernel) and the port's plain PyTorch version.  Tolerance: none.
Every volume is held bit for bit (``+inf`` placement included, bf16 as
its 16-bit patterns), and so are the pipelines' disparities and
volumes, for each cost -> sgm|cvf -> wta|dyn path of ``create_pipeline``
and for ``convert.pipeline_from_jax``.  At these heights (H <= 96) the
JAX package's banded-matrix row box of ZNCC equals the sequential sum
that the port takes (see ``stereomatch_tpu_torch/ops/cost.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stereomatch_tpu import cli_common as jax_cli
from stereomatch_tpu import cost as jax_cost
from stereomatch_tpu import texture as jax_texture
from stereomatch_tpu.ops import cost as jax_ops
from stereomatch_tpu_torch import cli_common, convert, tune
from stereomatch_tpu_torch.cost import (NCC, SAD, SSD, Birchfield, Census,
                                        SSDTexture, make_cost, tensor_cost)
from stereomatch_tpu_torch.ops import cost as ops
from stereomatch_tpu_torch.pipeline import Pipeline
from stereomatch_tpu_torch.texture import TextureImage
from stereomatch_tpu_torch.disparity_reduce import WinnerTakesAll
from stereomatch_tpu_torch.parallel import (make_disp_mesh,
                                            make_disp_sharded_wta, make_mesh,
                                            make_mesh_2d,
                                            make_sharded_estimate,
                                            make_tiled2d_estimate)

from .conftest import synthetic_stereo_pair
from .torch_threads import one_torch_thread  # noqa: F401

# (H, W, D, seed): widths below, at and above XLA's 16-column cumsum
# block, a multiple of it, and a non-square odd shape.
SCENES = [(24, 40, 8, 1), (32, 48, 16, 3), (17, 33, 9, 4), (20, 12, 6, 2),
          (96, 128, 32, 5)]


def _pair(h, w, d, seed):
    left, right, _ = synthetic_stereo_pair(h, w, d, seed=seed)
    return left, right


def _same(ref, out):
    ref = np.asarray(ref)
    if ref.dtype.name == "bfloat16":
        ref = ref.view(np.int16)
        out = out.view(torch.int16)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("scene", SCENES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("k,offset", [(4, 0), (1, 0), (7, 3)])
def test_birchfield_volume_equals_jax(scene, k, offset):
    left, right = _pair(*scene)
    d = scene[2]
    kw = dict(max_disparity=d, kernel_size=k, disparity_offset=offset)
    out = ops.birchfield_cost_volume(torch.from_numpy(left),
                                     torch.from_numpy(right), **kw)
    assert out.dtype == torch.float32
    _same(jax_ops.birchfield_cost_volume(left, right, **kw), out)


def test_birchfield_uint8_images_and_class_default():
    left, right = _pair(24, 40, 8, 6)
    l8, r8 = (left * 255).astype(np.uint8), (right * 255).astype(np.uint8)
    assert Birchfield(8).kernel_size == jax_cost.Birchfield(8).kernel_size
    _same(jax_cost.Birchfield(8)(l8, r8),
          Birchfield(8)(torch.from_numpy(l8), torch.from_numpy(r8)))


@pytest.mark.parametrize("scene", SCENES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("k,offset,dtype", [
    (7, 0, "float32"), (3, 0, "float32"), (3, 2, "float32"),
    (4, 0, "bfloat16")])
def test_zncc_volume_equals_jax(scene, k, offset, dtype):
    left, right = _pair(*scene)
    d = scene[2]
    kw = dict(max_disparity=d, kernel_size=k, disparity_offset=offset)
    out = ops.zncc_cost_volume(torch.from_numpy(left),
                               torch.from_numpy(right),
                               cost_dtype=getattr(torch, dtype), **kw)
    _same(jax_ops.zncc_cost_volume(left, right,
                                   cost_dtype=getattr(jnp, dtype), **kw),
          out)


@pytest.mark.parametrize("h,w,d,k", [(20, 6, 4, 7), (20, 12, 16, 3),
                                     (9, 5, 8, 2)],
                         ids=["W<=k", "D>W+1", "both"])
def test_zncc_degenerate_geometry_equals_jax(h, w, d, k):
    """W <= k or D > W + 1: the stacked formulation of the six window
    statistics, in both packages."""
    left, right = _pair(h, w, 4, 2)
    out = ops.zncc_cost_volume(torch.from_numpy(left),
                               torch.from_numpy(right), max_disparity=d,
                               kernel_size=k)
    _same(jax_ops.zncc_cost_volume(left, right, max_disparity=d,
                                   kernel_size=k), out)


def test_zncc_refuses_integer_volumes():
    left, right = _pair(16, 24, 4, 1)
    with pytest.raises(ValueError, match="float"):
        ops.zncc_cost_volume(torch.from_numpy(left), torch.from_numpy(right),
                             max_disparity=4, cost_dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        cli_common.create_pipeline("ncc", "wta", volume_dtype="int32",
                                   device="cpu")


@pytest.mark.parametrize("shape", [(13, 40), (24, 40), (7, 64), (5, 3),
                                   (1, 1), (3, 17)])
def test_pairwise_sum_and_stable_mean_equal_jax(shape):
    img = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32) * 100
    t = torch.from_numpy(img)
    _same(jax_ops.pairwise_sum_last(img), ops.pairwise_sum_last(t))
    _same(jax_ops.stable_image_mean(img), ops.stable_image_mean(t))


@pytest.mark.parametrize("n_tiles", [1, 2, 4])
def test_zncc_row_bands_equal_the_whole_volume(n_tiles):
    """Bands with (k, k-1) halos, the rows beyond the image marked and the
    whole images' sums: the whole volume's rows bit for bit."""
    h, w, d, k = 32, 48, 16, 3
    left, right = map(torch.from_numpy, _pair(h, w, d, 3))
    whole = ops.zncc_cost_volume(left, right, max_disparity=d, kernel_size=k)
    hl = h // n_tiles
    bands = []
    for t in range(n_tiles):
        rows = torch.arange(t * hl - k, (t + 1) * hl + k - 1)
        inside = (rows >= 0) & (rows < h)
        lp, rp = (torch.where(inside[:, None], x[rows.clamp(0, h - 1)], 0.0)
                  for x in (left, right))
        bands.append(ops.zncc_cost_from_padded(
            lp, rp, pad_before=k, pad_after=k - 1, max_disparity=d,
            kernel_size=k, row_valid=inside, left_total=ops.image_sum(left),
            right_total=ops.image_sum(right), image_size=h * w))
    assert torch.equal(torch.cat(bands), whole)
    with pytest.raises(ValueError, match="halos"):
        ops.zncc_cost_from_padded(
            left, right, pad_before=k + 1, pad_after=0, max_disparity=d,
            kernel_size=k, row_valid=torch.ones(h, dtype=torch.bool),
            left_total=ops.image_sum(left),
            right_total=ops.image_sum(right), image_size=h * w)


def test_ssd_texture_equals_jax_and_ssd():
    left, right = _pair(24, 40, 8, 7)
    jl = jax_texture.TextureImage.from_array(left)
    jr = jax_texture.TextureImage.from_array(right)
    ref = jax_cost.SSDTexture(8, kernel_size=3)(jl, jr)
    tl, tr = TextureImage.from_array(left), TextureImage.from_array(right)
    out = SSDTexture(8, kernel_size=3)(tl, tr)
    _same(ref, out)
    _same(ref, SSDTexture(8, kernel_size=3, backend="torch")(tl, tr))
    assert torch.equal(out, SSD(8, kernel_size=3)(torch.from_numpy(left),
                                                  torch.from_numpy(right)))
    with pytest.raises(TypeError):
        SSDTexture(8)(torch.from_numpy(left), torch.from_numpy(right))
    square = np.zeros((8, 16), np.float32)
    with pytest.raises(RuntimeError, match="normalized"):
        SSDTexture(8)(TextureImage(square, use_normalized_coords=True),
                      TextureImage(square, use_normalized_coords=True))


def test_pipeline_wraps_texture_costs():
    left, right = _pair(24, 40, 8, 8)
    pipe = Pipeline(SSDTexture(8), WinnerTakesAll(), device="cpu")
    assert pipe.cost.max_disparity == 8
    pipe.cost.max_disparity = 6
    assert pipe.cost.cost_function.max_disparity == 6
    assert tuple(pipe.estimate(left, right).shape) == (24, 40)
    assert pipe._cost_volume.shape[2] == 6


@pytest.mark.parametrize("cost", ["birchfield", "ncc", "ssd-texture"])
@pytest.mark.parametrize("aggr,reducer", [
    (None, "wta"), ("sgm", "wta"), ("sgm", "dyn"), ("cvf", "wta"),
    ("cvf", "dyn")])
def test_create_pipeline_paths_equal_jax(cost, aggr, reducer):
    left, right = _pair(32, 48, 16, 9)
    kw = dict(max_disparity=16, penalty1=0.15, penalty2=0.4, cvf_radius=3)
    jax_pipe = jax_cli.create_pipeline(cost, reducer, aggr, backend="xla",
                                       **kw)
    pipe = cli_common.create_pipeline(cost, reducer, aggr, device="cpu",
                                      **kw)
    ref = np.asarray(jax_pipe.estimate(left, right))
    out = pipe.estimate(left, right)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
    _same(jax_pipe._cost_volume, pipe._cost_volume)
    _same(jax_pipe._aggregation_volume, pipe._aggregation_volume)


@pytest.mark.parametrize("cost,dtype", [
    ("birchfield", "bfloat16"), ("ssd-texture", "bfloat16"),
    ("ncc", "bfloat16"), ("ncc", "float32")])
def test_volume_dtype_rules_equal_jax(cost, dtype):
    """ncc stores the asked dtype; birchfield and ssd-texture compute
    float32 whatever it is, as in the JAX package."""
    left, right = _pair(24, 40, 8, 10)
    jax_pipe = jax_cli.create_pipeline(cost, "wta", "sgm", max_disparity=8,
                                       volume_dtype=dtype, backend="xla")
    pipe = cli_common.create_pipeline(cost, "wta", "sgm", max_disparity=8,
                                      volume_dtype=dtype, device="cpu")
    np.testing.assert_array_equal(pipe.estimate(left, right).numpy(),
                                  np.asarray(jax_pipe.estimate(left, right)))
    assert str(pipe._cost_volume.dtype).replace("torch.", "") == \
        str(np.asarray(jax_pipe._cost_volume).dtype)
    _same(jax_pipe._aggregation_volume, pipe._aggregation_volume)


@pytest.mark.parametrize("cost,cls", [("birchfield", Birchfield),
                                      ("ncc", NCC),
                                      ("ssd-texture", SSDTexture)])
def test_convert_carries_the_three_classes(cost, cls):
    left, right = _pair(24, 40, 8, 11)
    jax_pipe = jax_cli.create_pipeline(cost, "dyn", "sgm", max_disparity=8,
                                       backend="xla")
    inner = getattr(jax_pipe.cost, "cost_function", jax_pipe.cost)
    inner.kernel_size = 3
    port = convert.pipeline_from_jax(jax_pipe, device="cpu")
    port_cost = getattr(port.cost, "cost_function", port.cost)
    assert isinstance(port_cost, cls)
    assert (port_cost.max_disparity, port_cost.kernel_size) == (8, 3)
    np.testing.assert_array_equal(port.estimate(left, right).numpy(),
                                  np.asarray(jax_pipe.estimate(left, right)))


# Registry name -> (class, default kernel_size, row halo of a 9x7 census
# window), as the factory built each stage before ``make_cost`` took the
# decision over.
STAGES = {"ssd": (SSD, 7, (7, 6)), "sad": (SAD, 7, (7, 6)),
          "ncc": (NCC, 7, (7, 6)), "ssd-texture": (SSDTexture, 7, (7, 6)),
          "birchfield": (Birchfield, 4, (0, 0)), "census": (Census, 1, (3, 3))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("name", sorted(STAGES))
def test_make_cost_is_the_one_name_to_stage_decision(name, dtype):
    """``make_cost`` builds the stage ``create_pipeline`` runs, with its
    class's default window and the row halo the mesh builders read; the
    builders refuse an unknown name, and the two that take an int32
    volume refuse it for ncc."""
    cpu = torch.device("cpu")
    torch_dtype = cli_common.VOLUME_DTYPES[dtype]
    kw = dict(census_window=9, census_height=7, backend="torch")
    builders = {
        "create_pipeline": lambda cost: cli_common.create_pipeline(
            cost, "wta", max_disparity=8, volume_dtype=dtype, device="cpu",
            **kw),
        "make_sharded_estimate": lambda cost: make_sharded_estimate(
            make_mesh([cpu] * 2, n_tile=2), max_disparity=8, cost=cost,
            cost_dtype=dtype, aggregation=None),
        "make_tiled2d_estimate": lambda cost: make_tiled2d_estimate(
            make_mesh_2d([cpu] * 4, 1, 2, 2), max_disparity=8, cost=cost),
        "make_disp_sharded_wta": lambda cost: make_disp_sharded_wta(
            make_disp_mesh([cpu] * 2), max_disparity=8, cost=cost,
            cost_dtype=dtype),
        "tune_penalties": lambda cost: tune.tune_penalties(
            [_pair(16, 24, 8, 1) + (np.zeros((16, 24), np.float32),)],
            max_disparity=8, cost=cost, steps=1, device="cpu")}
    for builder in builders.values():
        with pytest.raises(ValueError, match="unknown cost"):
            builder(name.upper())
    if name == "ncc" and dtype == "int32":
        for builder in ("create_pipeline", "make_sharded_estimate"):
            with pytest.raises(ValueError, match="int32"):
                builders[builder](name)
        with pytest.raises(ValueError, match="int32"):
            make_cost(name, 8, cost_dtype=torch_dtype)
        return
    cls, kernel_size, halo = STAGES[name]
    stage = make_cost(name, 8, cost_dtype=torch_dtype, **kw)
    pipe = builders["create_pipeline"](name)
    built = getattr(pipe.cost, "cost_function", pipe.cost)
    assert type(stage) is type(built) is cls
    assert vars(stage) == vars(built)
    assert (stage.max_disparity, stage.kernel_size) == (8, kernel_size)
    assert stage.row_halo == halo
    if cls in (SSD, SAD, NCC, Census):
        assert stage.cost_volume_dtype == torch_dtype
    if cls in (SSD, SAD, SSDTexture, Census):
        assert stage.backend == "torch"
    if cls is Census:
        assert (stage.window_size, stage.window_height) == (9, 7)
        assert make_cost(name, 8).row_halo == (2, 2)
    else:
        assert make_cost(name, 8, kernel_size=3).row_halo == (
            (0, 0) if cls is Birchfield else (3, 2))
    plain = tensor_cost(name, 8, cost_dtype=torch_dtype, **kw)
    if cls is SSDTexture:
        assert type(plain) is SSD
        assert plain.cost_volume_dtype == torch.float32
        assert (plain.kernel_size, plain.row_halo) == (7, (7, 6))
    else:
        assert vars(plain) == vars(stage)
