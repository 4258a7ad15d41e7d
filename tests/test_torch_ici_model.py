"""The port's interconnect model (``parallel/ici_model.py``) against the
JAX package's, and ``sgm_mode="auto"`` in the port's partitioners.

Given the JAX module's explicit rates (its TPU defaults: 45 GB/s, 675
GB/s, 5 us), the port's ``ici_traffic_model``, ``select_exact_schedule``
and ``select_sgm_mode`` return JAX's results exactly, over teddy and HD
at 2-8 tiles and 1-8 frames a batch row and JAX's own cases
(``tests/test_parallel.py:75-82,760-775``).  The port's defaults are the
H100's measured rates, none of them JAX's.  ``ShardedPipeline`` and the
row-sharded pyramid with ``sgm_mode="auto"`` log the mode they resolve
to and equal that mode bit for bit; the sharded pipeline's equals JAX's
``ShardedPipeline`` at that mode.
"""

import functools
import inspect
import logging

import jax
import numpy as np
import pytest
import torch

from stereomatch_tpu.parallel import ShardedPipeline as JaxShardedPipeline
from stereomatch_tpu.parallel import ici_model as jax_ici
from stereomatch_tpu.parallel import make_mesh as jax_make_mesh
from stereomatch_tpu_torch.parallel import (ShardedPipeline, ici_model,
                                            make_mesh,
                                            make_pyramid_sharded_estimate,
                                            pyramid_sharded, sharded)

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair
from .torch_threads import one_torch_thread  # noqa: F401

D = STM_MAX_DISPARITY
CPU = torch.device("cpu")
# The JAX module's rates, passed explicitly to both models.
JAX_RATES = dict(ici_gbps=45.0, hbm_gbps=675.0)
JAX_HOP_US = 5.0
GEOMETRIES = {"teddy": (375, 450, 128), "hd": (1024, 1280, 256)}
GRID = [(name, tiles, batch) for name in GEOMETRIES
        for tiles in range(2, 9) for batch in range(1, 9)]


@pytest.mark.parametrize("name,tiles,batch", GRID)
def test_model_equals_jax_given_its_rates(name, tiles, batch):
    h, w, d = GEOMETRIES[name]
    geometry = dict(height=h, width=w, disp=d, tiles=tiles, batch=batch)
    assert ici_model.ici_traffic_model(
        **geometry, **JAX_RATES, hop_latency_us=JAX_HOP_US) == \
        jax_ici.ici_traffic_model(**geometry, **JAX_RATES,
                                  hop_latency_us=JAX_HOP_US)
    assert ici_model.select_sgm_mode(
        **geometry, **JAX_RATES, hop_latency_us=JAX_HOP_US) == \
        jax_ici.select_sgm_mode(**geometry, **JAX_RATES)
    assert ici_model.select_exact_schedule(tiles=tiles, batch=batch) == \
        jax_ici.select_exact_schedule(tiles=tiles, batch=batch)


JAX_CASES = [
    ("schedule", dict(tiles=4, batch=1)),
    ("schedule", dict(tiles=4, batch=2)),
    ("schedule", dict(tiles=4, batch=4)),
    ("schedule", dict(tiles=4, batch=8)),
    ("mode", dict(height=64, width=96, disp=32, tiles=4, batch=1)),
    ("mode", dict(height=4096, width=512, disp=64, tiles=4, batch=8)),
    ("mode", dict(height=375, width=450, disp=128, tiles=8, batch=1)),
    ("mode", dict(height=375, width=450, disp=128, tiles=8, batch=8)),
]


@pytest.mark.parametrize("kind,kw", JAX_CASES)
def test_jax_cases(kind, kw):
    """``tests/test_parallel.py``'s own cases, with JAX's rates."""
    if kind == "schedule":
        assert ici_model.select_exact_schedule(**kw) == \
            jax_ici.select_exact_schedule(**kw)
    else:
        assert ici_model.select_sgm_mode(
            **kw, **JAX_RATES, hop_latency_us=JAX_HOP_US) == \
            jax_ici.select_sgm_mode(**kw, **JAX_RATES)


@pytest.mark.parametrize("fn", ["ici_traffic_model", "select_sgm_mode"])
def test_defaults_are_the_cards_not_the_tpus(fn):
    """The rates default to the module's H100 constants, none of which is
    one of the JAX module's TPU figures; the other keywords keep JAX's
    defaults (``vmap_eff`` included)."""
    card = {"ici_gbps": ici_model.CARRY_GBPS, "hbm_gbps": ici_model.COPY_GBPS,
            "hop_latency_us": ici_model.STAGE_US}
    port = inspect.signature(getattr(ici_model, fn)).parameters
    jax_params = inspect.signature(getattr(jax_ici, fn)).parameters
    tpu = {jax_ici.ici_traffic_model.__kwdefaults__[k] for k in card}
    assert tpu == {45.0, 675.0, 5.0}
    for name, value in card.items():
        assert port[name].default == value > 0
        assert value not in tpu
    for name, param in jax_params.items():
        if name not in card:
            assert port[name].default == param.default, name
    assert inspect.signature(ici_model.select_exact_schedule) == \
        inspect.signature(jax_ici.select_exact_schedule)


@pytest.fixture(scope="module")
def stacks():
    frames = [synthetic_stereo_pair(32, 48, D, seed=s) for s in (7, 8)]
    return (np.stack([f[0] for f in frames]),
            np.stack([f[1] for f in frames]))


def _free_link(monkeypatch, module):
    """The model with a free link (no copy time, no stage latency), under
    which exact is always within 5% of overlap."""
    monkeypatch.setattr(module, "select_sgm_mode", functools.partial(
        ici_model.select_sgm_mode, ici_gbps=1e12, hop_latency_us=0.0))


def _resolved(caplog, logger):
    picks = [r.getMessage() for r in caplog.records if r.name == logger]
    assert len(picks) == 1, picks
    assert picks[0].startswith("sgm_mode=auto resolved to ")
    return picks[0].split("'")[1]


@pytest.mark.parametrize("link", ["card", "free"])
def test_sharded_auto_equals_its_resolved_mode(stacks, caplog, monkeypatch,
                                               link):
    """With the card's rates the 32x48 stacks resolve as the model says
    (the serial chain dominates such small tiles); with a free link,
    to exact.  Either way auto equals that mode, and JAX's sharded
    pipeline at it, bit for bit."""
    if link == "free":
        _free_link(monkeypatch, sharded)
    left, right = stacks
    mesh = make_mesh([CPU] * 8, n_batch=2)
    kw = dict(kernel_size=3)
    with caplog.at_level(logging.INFO, logger=sharded.__name__):
        auto = ShardedPipeline(mesh, D, sgm_mode="auto", **kw).estimate(
            left, right)
    mode = _resolved(caplog, sharded.__name__)
    want = "exact" if link == "free" else ici_model.select_sgm_mode(
        height=32, width=48, disp=D, tiles=4, batch=1)[0]
    assert mode == want
    explicit = ShardedPipeline(mesh, D, sgm_mode=mode, **kw).estimate(
        left, right)
    assert torch.equal(auto, explicit)
    jax_out = JaxShardedPipeline(
        jax_make_mesh(jax.devices()[:8], n_batch=2), D, sgm_mode=mode,
        backend="xla", **kw).estimate(left, right)
    np.testing.assert_array_equal(auto.numpy(), np.asarray(jax_out))


@pytest.mark.parametrize("link", ["card", "free"])
def test_pyramid_auto_equals_its_resolved_mode(stacks, caplog, monkeypatch,
                                               link):
    """The pyramid resolves from its coarse level (16x24, D/2) and
    equals the resolved mode's pyramid bit for bit."""
    if link == "free":
        _free_link(monkeypatch, sharded)
    left, right = stacks
    mesh = make_mesh([CPU] * 8, n_batch=2)
    with caplog.at_level(logging.INFO, logger=pyramid_sharded.__name__):
        auto = make_pyramid_sharded_estimate(
            mesh, max_disparity=D, levels=1, sgm_mode="auto")(left, right)
    mode = _resolved(caplog, pyramid_sharded.__name__)
    want = "exact" if link == "free" else ici_model.select_sgm_mode(
        height=16, width=24, disp=D // 2, tiles=4, batch=1)[0]
    assert mode == want
    explicit = make_pyramid_sharded_estimate(
        mesh, max_disparity=D, levels=1, sgm_mode=mode)(left, right)
    assert torch.equal(auto, explicit)
