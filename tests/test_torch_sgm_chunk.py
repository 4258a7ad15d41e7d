"""The port's chunk sweep with carry hand-off against the JAX package.

``ops.aggregation.sweep_chunk_with_carry`` is the plain version, and
oracle, of the chunk kernel (the TPU's K5 ``_chunk_kernel`` and K6
``_chunk_kernel_wgrid``).  The same numpy chunks go through:

* JAX's ``ops.aggregation.sgm_scan_with_carry`` with the flips of
  ``parallel/sharded.py::_handoff_sweep``: contributions and carries
  bit-equal;
* the Pallas ``sgm_pallas.sweep_chunk_with_carry`` in interpret mode (its
  three row families in one pass, P2 maps with the one-row image halo of
  ``_pallas_exact_semiglobal``), full width and with the W-on-grid form
  forced: carries bit-equal, contribution sums within the JAX package's
  Pallas-vs-XLA bound, rtol 2e-6 / atol 1e-5;

and the port's 5-tile exact pipeline reproduces the committed teddy
golden at every pixel.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from stereomatch_tpu.ops import sgm_pallas
from stereomatch_tpu.ops.aggregation import sgm_scan_with_carry as jax_scan
from stereomatch_tpu_torch.io.synthetic import stereo_pair
from stereomatch_tpu_torch.ops import aggregation as port_agg
from stereomatch_tpu_torch.parallel import ShardedPipeline, make_mesh

from .torch_shapes import CHUNK_SHORT_CASES
from .torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 2e-6, 1e-5     # Pallas family-sum order vs per-traversal sums
P1, P2 = 0.1, 0.2
ROW_STEPS = port_agg.TRAVERSALS[2:]
TEDDY = np.load(Path(__file__).parent / "data" / "golden_teddy_disparity.npz")


def _chunks(h, w, d, seed):
    rng = np.random.default_rng(seed)
    cost = rng.random((h, w, d), np.float32) * 4
    cost[:, :3, d // 2:] = np.inf                 # a wedge of +inf, as SSD
    return cost, rng.random((h, w), np.float32)


def _jax_chunk(cost, image, step, carry, seed):
    """_handoff_sweep's frame for one traversal: a W flip for the reverse
    diagonals, an H flip for every reverse traversal."""
    dy, dx = step
    shift = 0 if dx == 0 else (1 if dy == dx else -1)
    flip_w = dy < 0 and dx != 0
    if flip_w:
        cost, image = cost[:, ::-1], image[:, ::-1]
        carry = tuple(c[::-1] for c in carry)
    if dy < 0:
        cost, image = cost[::-1], image[::-1]
    (fin, fin_i), out = jax_scan(np.ascontiguousarray(cost),
                                 np.ascontiguousarray(image), P1, P2, shift,
                                 init_carry=carry, seed_first=seed)
    out, fin, fin_i = np.asarray(out), np.asarray(fin), np.asarray(fin_i)
    if dy < 0:
        out = out[::-1]
    if flip_w:
        out, fin, fin_i = out[:, ::-1], fin[::-1], fin_i[::-1]
    return out, (fin, fin_i)


def _port_chunk(cost, image, step, carry, seed):
    out, (fin, fin_i) = port_agg.sweep_chunk_with_carry(
        torch.from_numpy(np.ascontiguousarray(cost)),
        torch.from_numpy(np.ascontiguousarray(image)), step,
        *(None if c is None else torch.from_numpy(np.ascontiguousarray(c))
          for c in carry), penalty1=P1, penalty2=P2, seed=seed)
    return out.numpy(), (fin.numpy(), fin_i.numpy())


def _split(cost, image, step, cut):
    """(first chunk in scan order, second chunk) of an image cut at row
    ``cut``."""
    head = (cost[:cut], image[:cut])
    tail = (cost[cut:], image[cut:])
    return (head, tail) if step[0] > 0 else (tail, head)


@pytest.mark.parametrize("step", ROW_STEPS, ids=str)
def test_chunks_bit_equal_to_jax_scan_with_handoff_flips(step):
    cost, image = _chunks(19, 23, 10, seed=abs(step[0] * 3 + step[1]))
    first, second = _split(cost, image, step, cut=7)
    w, d = cost.shape[1:]
    seed_carry = (np.full((w, d), np.inf, np.float32),
                  np.zeros((w,), np.float32))
    ref1, carry_j = _jax_chunk(*first, step, seed_carry, seed=True)
    out1, carry_p = _port_chunk(*first, step, (None, None), seed=True)
    ref2, end_j = _jax_chunk(*second, step, carry_j, seed=False)
    out2, end_p = _port_chunk(*second, step, carry_p, seed=False)
    for out, ref in ((out1, ref1), (out2, ref2), (carry_p[0], carry_j[0]),
                     (carry_p[1], carry_j[1]), (end_p[0], end_j[0]),
                     (end_p[1], end_j[1])):
        np.testing.assert_array_equal(out, ref)
    # Split or whole, the traversal is the same.
    whole = port_agg.sweep(torch.from_numpy(cost), torch.from_numpy(image),
                           P1, P2, step).numpy()
    joined = (np.concatenate([out1, out2]) if step[0] > 0
              else np.concatenate([out2, out1]))
    np.testing.assert_array_equal(joined, whole)


@pytest.mark.parametrize("step", ROW_STEPS, ids=str)
@pytest.mark.parametrize("case", CHUNK_SHORT_CASES,
                         ids=lambda case: f"d{case[0][2]}")
def test_short_chunks_bit_equal_to_jax_scan(case, step):
    """Chunks of 1, 3, 7 and 1 rows in scan order (the card tests' short
    chunks, shorter than the chunk kernel's ring), each from the carry of
    the chunk before it: contributions and carries bit-equal to JAX."""
    (h, w, d, _), cuts = case
    cost, image = _chunks(h, w, d, seed=3 * d + 2 * step[1] + step[0] + 3)
    edges = [0, *cuts, h]
    spans = list(zip(edges[:-1], edges[1:]))
    carry_j = (np.full((w, d), np.inf, np.float32),
               np.zeros((w,), np.float32))
    carry_p = (None, None)
    parts = {}
    for rank, (a, b) in enumerate(spans if step[0] > 0 else spans[::-1]):
        ref, carry_j = _jax_chunk(cost[a:b], image[a:b], step, carry_j,
                                  seed=rank == 0)
        out, carry_p = _port_chunk(cost[a:b], image[a:b], step, carry_p,
                                   seed=rank == 0)
        for got, want in ((out, ref), (carry_p[0], carry_j[0]),
                          (carry_p[1], carry_j[1])):
            np.testing.assert_array_equal(got, want)
        parts[a] = out
    whole = port_agg.sweep(torch.from_numpy(cost), torch.from_numpy(image),
                           P1, P2, step).numpy()
    np.testing.assert_array_equal(
        np.concatenate([parts[a] for a, _ in spans]), whole)


def test_chunk_refuses_what_it_does_not_take():
    cost, image = (torch.from_numpy(a) for a in _chunks(4, 5, 3, seed=1))
    with pytest.raises(ValueError, match="row traversal"):
        port_agg.sweep_chunk_with_carry(cost, image, (0, 1), penalty1=P1,
                                        penalty2=P2, seed=True)
    with pytest.raises(ValueError, match="carry"):
        port_agg.sweep_chunk_with_carry(cost, image, (1, 0), penalty1=P1,
                                        penalty2=P2, seed=False)


def _pallas_chunk(cost, image, halo_row, carries, reverse, seed):
    """The three row families of one direction through the Pallas chunk
    kernel, P2 maps with the one-row image halo of the sharded path."""
    shifts = sgm_pallas._FAMILY_SHIFTS
    if reverse:
        ext = np.concatenate([image, halo_row[None]])
        pm = sgm_pallas._p2_maps(ext, P1, P2, shifts, reverse=True)[:-1]
    else:
        ext = np.concatenate([halo_row[None], image])
        pm = sgm_pallas._p2_maps(ext, P1, P2, shifts, reverse=False)[1:]
    out, carry = sgm_pallas.sweep_chunk_with_carry(
        cost, pm, np.stack(carries), seed, families=shifts, penalty1=P1,
        reverse=reverse, interpret=True)
    return np.asarray(out), np.asarray(carry)


# The traversal of each Pallas family (shift s: predecessor x - s going
# down, x + s going up), in the order of _FAMILY_SHIFTS.
_FAMILY_STEPS = {False: ((1, 0), (1, 1), (1, -1)),
                 True: ((-1, 0), (-1, -1), (-1, 1))}


@pytest.mark.parametrize("wgrid", [False, True], ids=["K5", "K6"])
@pytest.mark.parametrize("reverse", [False, True], ids=["down", "up"])
def test_row_families_close_to_pallas_chunk_kernel(monkeypatch, reverse,
                                                   wgrid):
    """A chunk with a real carry (the port's plain carry of the chunk
    before it in scan order) through both implementations."""
    cost, image = _chunks(20, 48, 16, seed=7 + reverse)
    if wgrid:
        monkeypatch.setattr(sgm_pallas, "_VMEM_BUDGET_BYTES", 0)
        assert not sgm_pallas._chunk_fits_full_width(48, 16, 3)
        assert sgm_pallas._pick_wgrid_chunks(48, 16, 3) == 2
    else:
        assert sgm_pallas._chunk_fits_full_width(48, 16, 3)
    steps = _FAMILY_STEPS[reverse]
    first, second = _split(cost, image, steps[0], cut=9)
    carries, total, ends = [], None, []
    for step in steps:
        _, carry = _port_chunk(*first, step, (None, None), seed=True)
        out, end = _port_chunk(*second, step, carry, seed=False)
        carries.append(carry[0])
        ends.append(end[0])
        total = out if total is None else total + out
    halo_row = carry[1]          # the intensity row before the chunk
    ref, ref_end = _pallas_chunk(*second, halo_row, carries, reverse,
                                 seed=False)
    finite = np.isfinite(ref)
    assert np.array_equal(finite, np.isfinite(total))
    np.testing.assert_allclose(total[finite], ref[finite], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(np.stack(ends), ref_end)


@pytest.mark.parametrize("reducer,key", [("wta", "wta"),
                                         ("dynamic_programming", "dp")])
def test_sharded_exact_teddy_reproduces_golden(reducer, key):
    """5 row tiles of 75 rows on the CPU, as tests/test_golden_teddy.py
    runs the JAX pipeline on a 5-device mesh."""
    g = TEDDY
    d = int(g["max_disparity"])
    left, right, _ = stereo_pair(int(g["height"]), int(g["width"]), d,
                                 seed=int(g["seed"]))
    mesh = make_mesh([torch.device("cpu")] * 5, n_tile=5)
    pipe = ShardedPipeline(mesh, d, kernel_size=int(g["kernel_size"]),
                           aggregation="sgm", reducer=reducer,
                           sgm_mode="exact", penalty1=float(g["penalty1"]),
                           penalty2=float(g["penalty2"]))
    out = pipe.estimate(left, right)              # 2-D in -> 2-D out
    assert out.shape == left.shape and out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), g[key])
