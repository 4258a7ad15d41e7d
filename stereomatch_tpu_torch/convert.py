"""Build the port's pipeline and mesh from the JAX package's.

The stereo engine has no weights: the state that carries across is each
stage's configuration (the cost's ``max_disparity``, ``kernel_size``,
``cost_volume_dtype`` (float32, bfloat16 or int32; Birchfield and
SSDTexture have none: float32) and census ``window_size``, the SGM
penalties, the guided filter's radius, eps, subsample and wedge
offset, the reducer) and, for the partitioners (row tiles, 2-D tiles,
disparity blocks), the mesh layout (their configuration is taken under
the same keywords on both sides); for ``PyramidPipeline`` and
``TemporalPipeline`` their settings and the keyframe pipeline; a
``tune.TuneResult`` is plain data.  It is read from the JAX objects by
attribute and class name, so this module never imports JAX and works on
any object of that shape.  :func:`tensor_from_jax` carries an array (an
image, a volume), bf16 included.  The JAX objects' ``backend`` is not
carried: the port's stages take ``"auto"`` (the kernels on the card),
which give the same results.
"""

from __future__ import annotations

import numpy as np
import torch

from .aggregation import CostFilter, Semiglobal
from .cost import NCC, SAD, SSD, Birchfield, Census, SSDTexture
from .disparity_reduce import DynamicProgramming, WinnerTakesAll
from .parallel.disp_sharded import DISP_AXIS, make_disp_mesh
from .parallel.mesh import BATCH_AXIS, TILE_AXIS, Mesh, make_mesh
from .parallel.tiled2d import TILE_W_AXIS, make_mesh_2d
from .pipeline import Device, Pipeline, tensor_from_numpy
from .pyramid import PyramidPipeline
from .temporal import TemporalPipeline
from .tune import TuneResult
from .utils import validation

_COSTS = {"SSD": SSD, "SAD": SAD, "Census": Census, "NCC": NCC,
          "Birchfield": Birchfield, "SSDTexture": SSDTexture}
# The cost classes whose volume dtype is a setting (the others compute
# float32).
_DTYPED = ("SSD", "SAD", "Census", "NCC")


def _kind(stage) -> str:
    cls = type(stage)
    if not cls.__module__.startswith("stereomatch_tpu."):
        raise TypeError(f"{cls.__module__}.{cls.__name__} is not a stage of "
                        "the JAX package stereomatch_tpu")
    return cls.__name__


def _not_ported(kind: str):
    return NotImplementedError(
        f"the JAX stage {kind} is not ported to stereomatch_tpu_torch yet "
        "(see ROADMAP.md queue A)")


def _dtype(jax_dtype) -> torch.dtype:
    try:
        return validation.volume_dtype(jax_dtype)
    except ValueError:
        raise _not_ported("cost volume dtype "
                          f"{validation.dtype_name(jax_dtype)}") from None


def tensor_from_jax(array, device: Device = "cuda") -> torch.Tensor:
    """A JAX (or numpy) array as a tensor on ``device`` (the card unless
    ``"cpu"`` is asked for), bit for bit: a bf16 array crosses as its
    16-bit patterns (``pipeline.tensor_from_numpy``)."""
    return tensor_from_numpy(np.asarray(array)).to(device)


def pipeline_from_jax(jax_pipeline, device: Device = "cuda") -> Pipeline:
    """The port's equivalent of ``jax_pipeline``, running on ``device``
    (the card unless ``"cpu"`` is asked for)."""
    cost = jax_pipeline.cost
    kind = _kind(cost)
    if kind == "_TexCostFunctionWrapper":     # the JAX pipeline's wrap
        cost = cost.cost_function
        kind = _kind(cost)
    if kind not in _COSTS:
        raise _not_ported(kind)
    extra = {"window_size": cost.window_size} if kind == "Census" else {}
    if kind in _DTYPED:
        extra["cost_volume_dtype"] = _dtype(cost.cost_volume_dtype)
    port_cost = _COSTS[kind](cost.max_disparity,
                             kernel_size=cost.kernel_size, **extra)

    port_aggregation = None
    if jax_pipeline.aggregation is not None:
        agg = jax_pipeline.aggregation
        kind = _kind(agg)
        if kind == "Semiglobal":
            port_aggregation = Semiglobal(penalty1=agg.penalty1,
                                          penalty2=agg.penalty2)
        elif kind == "CostFilter":
            port_aggregation = CostFilter(radius=agg.radius, eps=agg.eps,
                                          subsample=agg.subsample,
                                          wedge_offset=agg.wedge_offset)
        else:
            raise _not_ported(kind)

    kind = _kind(jax_pipeline.disparity_reduce)
    reducers = {"WinnerTakesAll": WinnerTakesAll,
                "DynamicProgramming": DynamicProgramming}
    if kind not in reducers:
        raise _not_ported(kind)
    return Pipeline(port_cost, reducers[kind](),
                    aggregation=port_aggregation, device=device)


def mesh_from_jax(jax_mesh, devices) -> Mesh:
    """The (batch, tile) layout of a JAX package mesh laid over the given
    torch devices (as many as the JAX mesh has; they may repeat)."""
    shape = jax_mesh.shape
    n_batch, n_tile = int(shape[BATCH_AXIS]), int(shape[TILE_AXIS])
    devices = list(devices)
    if len(devices) != n_batch * n_tile:
        raise ValueError(f"the JAX mesh is {n_batch} x {n_tile}; got "
                         f"{len(devices)} torch devices")
    return make_mesh(devices, n_batch=n_batch)


def mesh_2d_from_jax(jax_mesh, devices) -> Mesh:
    """The (batch, tile, tile_w) layout of a JAX package 2-D tile mesh
    (``make_mesh_2d``) laid over the given torch devices."""
    shape = jax_mesh.shape
    dims = [int(shape[a]) for a in (BATCH_AXIS, TILE_AXIS, TILE_W_AXIS)]
    devices = list(devices)
    if len(devices) != int(np.prod(dims)):
        raise ValueError(f"the JAX mesh is {' x '.join(map(str, dims))}; "
                         f"got {len(devices)} torch devices")
    return make_mesh_2d(devices, *dims)


def disp_mesh_from_jax(jax_mesh, devices) -> Mesh:
    """The one-axis ``disp`` layout of a JAX package disparity-block mesh
    (``make_disp_mesh``) laid over the given torch devices."""
    n_disp = int(jax_mesh.shape[DISP_AXIS])
    devices = list(devices)
    if len(devices) != n_disp:
        raise ValueError(f"the JAX mesh has {n_disp} disparity blocks; got "
                         f"{len(devices)} torch devices")
    return make_disp_mesh(devices)


def pyramid_from_jax(jax_pyramid, device: Device = "cuda") -> PyramidPipeline:
    """The port's equivalent of a JAX ``PyramidPipeline``, running on
    ``device`` (the card unless ``"cpu"`` is asked for)."""
    kind = _kind(jax_pyramid)
    if kind != "PyramidPipeline":
        raise TypeError(f"expected a PyramidPipeline, got {kind}")
    return PyramidPipeline(
        jax_pyramid.max_disparity, levels=jax_pyramid.levels,
        band_radius=jax_pyramid.band_radius,
        window_size=jax_pyramid.window_size,
        band_kernel_size=jax_pyramid.band_kernel_size,
        penalty1=jax_pyramid.penalty1, penalty2=jax_pyramid.penalty2,
        cost_dtype=validation.dtype_name(jax_pyramid.cost_dtype),
        median=jax_pyramid.median, device=device)


def temporal_from_jax(jax_temporal, device: Device = "cuda"
                      ) -> TemporalPipeline:
    """The port's equivalent of a single-device JAX ``TemporalPipeline``
    (its keyframe a ``Pipeline`` or a ``PyramidPipeline``; ``poor_bits``
    as resolved there), fresh: tracking state is not carried.  A mesh
    tracker's keyframe is a JAX ``ShardedPipeline``, whose configuration
    lives in a compiled closure: build ``TemporalPipeline(mesh=...)`` on
    the port's mesh (:func:`mesh_from_jax`) instead."""
    kind = _kind(jax_temporal)
    if kind != "TemporalPipeline":
        raise TypeError(f"expected a TemporalPipeline, got {kind}")
    if jax_temporal.mesh is not None:
        raise ValueError("a mesh TemporalPipeline's keyframe configuration "
                         "is not readable from the JAX object; build "
                         "TemporalPipeline(..., mesh=mesh_from_jax(...))")
    keyframe = jax_temporal.keyframe
    if _kind(keyframe) == "PyramidPipeline":
        keyframe = pyramid_from_jax(keyframe, device=device)
    else:
        keyframe = pipeline_from_jax(keyframe, device=device)
    return TemporalPipeline(
        jax_temporal.max_disparity, keyframe=keyframe,
        band_radius=jax_temporal.band_radius,
        window_size=jax_temporal.window_size,
        keyframe_interval=jax_temporal.keyframe_interval,
        drift_threshold=jax_temporal.drift_threshold,
        poor_bits=jax_temporal.poor_bits, median=jax_temporal.median,
        device=device)


def tune_result_from_jax(jax_result) -> TuneResult:
    """A JAX ``tune.TuneResult`` as the port's (plain data: the penalties
    as floats, the histories as float32 numpy arrays)."""
    return TuneResult(
        penalty1=float(jax_result.penalty1),
        penalty2=float(jax_result.penalty2),
        loss_history=np.asarray(jax_result.loss_history, np.float32),
        penalty_history=np.asarray(jax_result.penalty_history, np.float32))
