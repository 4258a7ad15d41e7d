"""Build the port's pipeline and mesh from the JAX package's.

The stereo engine has no weights: the state that carries across is each
stage's configuration (the cost's ``max_disparity``, ``kernel_size``,
``cost_volume_dtype`` (float32, bfloat16 or int32) and census
``window_size``, the SGM penalties, the guided filter's radius, eps,
subsample and wedge offset, the reducer) and, for the row-sharded
pipeline, the mesh layout (its configuration is taken under the same
keywords on both sides).  It is read from the JAX objects by attribute
and class name, so this module never imports JAX and works on any object
of that shape.  :func:`tensor_from_jax` carries an array (an image, a
volume), bf16 included.
"""

from __future__ import annotations

import numpy as np
import torch

from .aggregation import CostFilter, Semiglobal
from .cost import SAD, SSD, Census
from .disparity_reduce import DynamicProgramming, WinnerTakesAll
from .parallel.mesh import BATCH_AXIS, TILE_AXIS, Mesh, make_mesh
from .pipeline import Device, Pipeline, tensor_from_numpy
from .utils import validation

_COSTS = {"SSD": SSD, "SAD": SAD, "Census": Census}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int32": torch.int32}


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
    name = validation.dtype_name(jax_dtype)
    if name not in _DTYPES:
        raise _not_ported(f"cost volume dtype {name}")
    return _DTYPES[name]


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
    if kind not in _COSTS:
        raise _not_ported(kind)
    extra = {"window_size": cost.window_size} if kind == "Census" else {}
    port_cost = _COSTS[kind](cost.max_disparity,
                             kernel_size=cost.kernel_size,
                             cost_volume_dtype=_dtype(cost.cost_volume_dtype),
                             **extra)

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
