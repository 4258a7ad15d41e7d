"""Every public call of the JAX package has its counterpart in the port.

For each module of ``stereomatch_tpu`` (parametrised by module), the
module of the same path in ``stereomatch_tpu_torch`` (a ``*_pallas``
module: the ``*_cuda`` launcher module of the same kernel) holds:

* every public function and class that the JAX module defines (not
  those it imports), and every public method, property, ``__init__``
  and ``__call__`` of those classes;
* for each of them, every keyword of the JAX signature: a parameter of
  the same name in the port's signature, or a ``**kwargs``.

The only exceptions are in ALLOWED below, one entry a name or keyword,
each with its reason: TPU mechanics (the MXU lowering, Pallas interpret
mode, the Pallas entry points, whose counterparts are the CUDA
launchers named beside them) and ``shard_map`` mechanics (a mesh axis
name and a tile count, the traced per-device block, where the port
takes the list of tile blocks, and the exact SGM hand-off's fill
order).  Any other gap fails.
"""

import importlib
import inspect
import pkgutil

import pytest

import stereomatch_tpu

PALLAS_TO_CUDA = {"ssd_pallas": "ssd_cuda", "sgm_pallas": "sgm_cuda",
                  "dp_pallas": "dp_cuda", "cvf_pallas": "cvf_cuda"}

_MXU = ("the TPU's matrix-unit lowering of the row box; the port sums "
        "every box in window order, XLA's reduce_window association")
_TRACED = ("shard_map's per-device block; the port takes the list of tile "
           "blocks, one a device of the mesh")
_AXIS = ("shard_map's mesh axis name; the port's tiles are the list's "
         "entries")
_TILES = "shard_map's tile count; the port's is the length of the list"

# (module, name) or (module, name, keyword) -> reason.
ALLOWED = {
    ("ops.cost", "mxu_leading_box_ok"): _MXU,
    ("ops.cost", "mxu_leading_box"): _MXU,
    ("ops.cost", "zncc_cost_from_padded", "use_mxu"): _MXU,
    ("ops.cost", "zncc_cost_from_padded", "left_mean"): (
        "a mesh caller's all-gathered mean; the port takes the whole "
        "image's sum (left_total) and size, from which it centres as "
        "XLA compiles the single-device path"),
    ("ops.cost", "zncc_cost_from_padded", "right_mean"): (
        "as left_mean: the port takes right_total"),
    ("ops.cvf", "guided_filter_aggregate", "use_mxu"): _MXU,
    ("ops.cvf", "guided_filter_from_padded", "use_mxu"): _MXU,
    ("parallel.pyramid_sharded", "make_pyramid_sharded_estimate",
     "interpret"): ("Pallas interpret mode; the port runs the plain "
                    "versions on CPU tiles"),
    ("parallel.halo", "pull_from_prev", "x"): _TRACED,
    ("parallel.halo", "pull_from_prev", "axis_name"): _AXIS,
    ("parallel.halo", "pull_from_next", "x"): _TRACED,
    ("parallel.halo", "pull_from_next", "axis_name"): _AXIS,
    ("parallel.halo", "pull_from_prev_multi", "x"): _TRACED,
    ("parallel.halo", "pull_from_prev_multi", "axis_name"): _AXIS,
    ("parallel.halo", "pull_from_next_multi", "x"): _TRACED,
    ("parallel.halo", "pull_from_next_multi", "axis_name"): _AXIS,
    ("parallel.halo", "out_of_image_mask", "axis_name"): (
        "shard_map's mesh axis name, read for the device's index; the "
        "port takes the tile's rank"),
    ("parallel.halo", "pad_with_halos", "x"): _TRACED,
    ("parallel.halo", "pad_with_halos", "axis_name"): _AXIS,
    ("parallel.sharded", "sharded_semiglobal", "cost_vol"): (
        _TRACED + " (vols)"),
    ("parallel.sharded", "sharded_semiglobal", "left_image"): (
        _TRACED + " (imgs)"),
    ("parallel.sharded", "sharded_semiglobal", "axis_name"): _AXIS,
    ("parallel.sharded", "sharded_semiglobal", "n_tiles"): _TILES,
    ("parallel.sharded", "sharded_semiglobal", "schedule"): (
        "shard_map's exact-mode hand-off fill order, wavefront or naive, "
        "with the same output; the port makes one launch order (see "
        "parallel/sharded.py on sgm_schedule)"),
}

# A Pallas entry point -> its counterpart in the launcher module.
PALLAS_COUNTERPARTS = {
    ("ops.ssd_pallas", "ssd_pallas_supported"): "fits",
    ("ops.ssd_pallas", "ssd_pallas_preferred"): "fits",
    ("ops.ssd_pallas", "diff_cost_volume_pallas"): "diff_cost_volume_cuda",
    ("ops.ssd_pallas", "ssd_cost_volume_pallas"): "diff_cost_volume_cuda",
    ("ops.ssd_pallas", "sad_cost_volume_pallas"): "diff_cost_volume_cuda",
    ("ops.sgm_pallas", "semiglobal_aggregate_pallas"):
        "semiglobal_aggregate_cuda",
    ("ops.sgm_pallas", "sweep_chunk_with_carry"):
        "sweep_chunk_with_carry_cuda",
    ("ops.dp_pallas", "dynamic_programming_pallas"):
        "dynamic_programming_cuda",
    ("ops.cvf_pallas", "guided_filter_wedge_pallas"):
        "guided_filter_aggregate_cuda",
    ("ops.cvf_pallas", "guided_filter_wedge_chunked_pallas"):
        "guided_filter_aggregate_cuda",
    ("ops.cvf_pallas", "fused_wedge_fits"): "fits",
    ("ops.cvf_pallas", "pick_chunk_width"): "fits",
}
for _key, _target in PALLAS_COUNTERPARTS.items():
    ALLOWED[_key] = (f"a Pallas entry point with its own VMEM layout and "
                     f"signature; its counterpart is "
                     f"{PALLAS_TO_CUDA[_key[0].split('.')[-1]]}.{_target}")


def _jax_modules():
    names = ["stereomatch_tpu"]
    names += [m.name for m in pkgutil.walk_packages(
        stereomatch_tpu.__path__, "stereomatch_tpu.")]
    return sorted(names)


def _port_module(jax_name: str) -> str:
    parts = jax_name.split(".")
    parts[0] = "stereomatch_tpu_torch"
    parts[-1] = PALLAS_TO_CUDA.get(parts[-1], parts[-1])
    return ".".join(parts)


def _own_public(module):
    """The public functions and classes ``module`` defines itself."""
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_") or not callable(obj):
            continue
        if not (inspect.isfunction(obj) or inspect.isclass(obj)
                or hasattr(obj, "__wrapped__")):
            continue
        if getattr(inspect.unwrap(obj), "__module__", None) == \
                module.__name__:
            out[name] = obj
    return out


def _members(cls):
    """(name, JAX attribute) of a class's public methods, properties,
    ``__init__`` and ``__call__``, as defined in its own body."""
    for name, attr in vars(cls).items():
        if name.startswith("_") and name not in ("__init__", "__call__"):
            continue
        if isinstance(attr, (staticmethod, classmethod, property)) or \
                inspect.isfunction(attr):
            yield name, getattr(cls, name)


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _keyword_gaps(jax_obj, port_obj):
    want, have = _signature(jax_obj), _signature(port_obj)
    if want is None or have is None:
        return []
    if any(p.kind == p.VAR_KEYWORD for p in have.parameters.values()):
        return []
    return [p.name for p in want.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
            and p.name not in have.parameters]


def _gaps(jax_name: str) -> list:
    short = jax_name.split(".", 1)[1] if "." in jax_name else ""
    jax_mod = importlib.import_module(jax_name)
    port_mod = importlib.import_module(_port_module(jax_name))
    gaps = []
    for name, obj in _own_public(jax_mod).items():
        if (short, name) in ALLOWED:
            continue
        if not hasattr(port_mod, name):
            gaps.append(name)
            continue
        port_obj = getattr(port_mod, name)
        pairs = [(name, obj, port_obj)]
        if inspect.isclass(obj):
            for member, attr in _members(obj):
                if not hasattr(port_obj, member):
                    gaps.append(f"{name}.{member}")
                elif not isinstance(attr, property):
                    pairs.append((f"{name}.{member}", attr,
                                  getattr(port_obj, member)))
        for label, jax_obj, port_callable in pairs:
            gaps += [f"{label}({kw}=)"
                     for kw in _keyword_gaps(jax_obj, port_callable)
                     if (short, label, kw) not in ALLOWED]
    return gaps


JAX_MODULES = _jax_modules()


def test_every_module_has_a_port():
    assert len(JAX_MODULES) > 40
    for name in JAX_MODULES:
        importlib.import_module(_port_module(name))


@pytest.mark.parametrize("jax_name", JAX_MODULES)
def test_every_public_call_has_its_counterpart(jax_name):
    gaps = _gaps(jax_name)
    assert not gaps, f"{_port_module(jax_name)} lacks {gaps}"


def test_every_allowance_names_a_real_gap():
    """No entry of ALLOWED outlives its gap, and a Pallas entry point's
    counterpart exists."""
    for key in ALLOWED:
        jax_mod = importlib.import_module(f"stereomatch_tpu.{key[0]}")
        port_mod = importlib.import_module(_port_module(jax_mod.__name__))
        obj = getattr(jax_mod, key[1])
        if len(key) == 2:
            assert not hasattr(port_mod, key[1]), key
            target = PALLAS_COUNTERPARTS.get(key)
            assert target is None or callable(getattr(port_mod, target)), key
        else:
            assert key[2] in _signature(obj).parameters, key
            assert key[2] in _keyword_gaps(obj, getattr(port_mod, key[1])), \
                key
