"""The routing rule of ``backend="auto"`` (``utils/backend.py``) and the
launchers' ``fits`` predicates, on the CPU.

Under "auto" a CUDA tensor goes to a kernel only where the kernel serves
its shape; elsewhere the plain version runs on the same device, decided
before any launch.  Each predicate states the limit its launcher's
``ValueError`` enforces: D <= 512 for the SGM and DP kernels, r <= 34
for the CVF kernels, 1 to 4 code words and no box sum for the census
kernels, and for the SSD kernel the rows of the block grid and the
shared memory of one streamed row.  The SSD and CVF bounds are
held here against the tile arithmetic of ``csrc/ssd.cu`` and
``csrc/cvf.cu`` (``tile_of``), restated below.  The card tests
(``tests/test_torch_kernels_cuda.py``) run both sides of each bound.
"""

from types import SimpleNamespace

import pytest
import torch

from stereomatch_tpu_torch.ops import (census_cuda, cvf_cuda, dp_cuda,
                                       sgm_cuda, ssd_cuda)
from stereomatch_tpu_torch.ops.cost import census_backend
from stereomatch_tpu_torch.utils.backend import resolve_backend
from stereomatch_tpu_torch.utils.validation import census_words

from .torch_shapes import SSD_REFUSED_K

CARD_TENSOR = SimpleNamespace(is_cuda=True, device="cuda:0")
CPU_TENSOR = torch.zeros(1)


def _ssd_tile_found(k, d):
    """``csrc/ssd.cu`` ``tile_of``: whether some tile of (k, D) fits."""
    tx, target, most = 32, 74 * 1024, 227 * 1024
    shapes = [(8, 8), (4, 8), (2, 8), (1, 8), (4, 4), (2, 4), (1, 4),
              (2, 2), (1, 2)]

    def elems(g, td, rc):
        span = tx + 2 * k - 1
        return g * span * td + rc * (2 * span + td - 1)

    ramp = 2 * k + 1
    xb = 8 if ramp >= 8 else 4 if ramp >= 4 else 2
    td_max = 32 if d >= 32 else (d + 3) // 4 * 4
    for step in range(4):
        td = td_max if step == 0 else 32 >> step
        if step > 0 and td >= td_max:
            continue
        for g, shape_xb in shapes:
            if shape_xb != xb or g > ramp or (td < td_max and g > 1):
                continue
            if elems(g, td, g + 2 * k - 1) * 4 <= target:
                return True
    if xb != 8:
        return False
    return any(limit // 4 >= elems(1, 4, 0) + elems(0, 4, 1)
               for limit in (target, most))


def _cvf_tile_found(r, stats, in_bytes):
    """``csrc/cvf.cu`` ``tile_of`` with its ``Layout``."""
    tx = 32
    tiles = [(4, 8, 16), (4, 8, 8), (4, 8, 4), (2, 8, 4), (4, 4, 16),
             (2, 2, 16)]

    def layout_bytes(g, td):
        span = tx + 2 * r
        vol = (span * td * (1 if stats else 2) * in_bytes + 15) // 16 * 4
        row = vol + ((span + 3) // 4 * 4 if stats else 0)
        pd = (4 if stats else 1) * g * tx
        plane = pd + (2 * g * td if stats else 0)
        return ((g + 2 * r) * row + 2 * g * (span | 1) * td
                + 2 * plane) * 4

    return any(g <= 2 * r + 2 and xb <= 2 * r + 2
               and layout_bytes(g, td) <= limit
               for limit in (110 * 1024, 227 * 1024)
               for g, xb, td in tiles)


@pytest.mark.parametrize("k", [1, 3, 4, 7, 150, 4826, 4827, SSD_REFUSED_K])
def test_ssd_fits_is_the_kernels_tile_rule(k):
    found = all(_ssd_tile_found(k, d) for d in (1, 37, 128))
    assert ssd_cuda.fits(8, k) == found
    assert ssd_cuda.fits(8, k) == (k <= 4826)


def test_ssd_fits_the_block_grid_rows():
    assert ssd_cuda.fits(65535, 7) and not ssd_cuda.fits(65536, 7)
    assert not ssd_cuda.fits(8, SSD_REFUSED_K)


def test_cvf_fits_is_the_kernels_tile_rule():
    for r in range(0, 48):
        both = (_cvf_tile_found(r, True, 4) and _cvf_tile_found(r, True, 2)
                and _cvf_tile_found(r, False, 4))
        assert cvf_cuda.fits(r) == both, r
    assert cvf_cuda.fits(cvf_cuda.MAX_RADIUS)
    assert not cvf_cuda.fits(cvf_cuda.MAX_RADIUS + 1)


@pytest.mark.parametrize("module", [sgm_cuda, dp_cuda], ids=["sgm", "dp"])
def test_sgm_and_dp_fit_up_to_512_disparities(module):
    assert module.fits((8, 40, 512)) and module.fits((1, 1, 1))
    assert not module.fits((8, 40, 513)) and not module.fits((8, 40, 600))


# (width, height, code words): 1 to 4 words are served, up to 11x11.
CENSUS_WINDOWS = [(1, 1, 0), (3, 3, 1), (5, 5, 1), (7, 7, 2), (9, 7, 2),
                  (9, 9, 3), (11, 11, 4), (1, 129, 4), (13, 13, 6),
                  (11, 13, 5)]


@pytest.mark.parametrize("width,height,words", CENSUS_WINDOWS, ids=str)
def test_census_fits_one_to_four_words_pixelwise(width, height, words):
    assert census_words(width, height) == words
    served = 1 <= words <= census_cuda.MAX_WORDS
    assert census_cuda.fits(words, 1) == served
    assert not census_cuda.fits(words, 2) and not census_cuda.fits(words, 7)
    assert census_backend("auto", CARD_TENSOR, width, height, 1) == (
        "cuda" if served else "torch")
    assert census_backend("auto", CARD_TENSOR, width, height, 3) == "torch"
    assert census_backend("auto", CPU_TENSOR, width, height, 1) == "torch"


def test_census_fits_refuses_five_words_and_box_sums():
    assert census_cuda.fits(4, 1) and not census_cuda.fits(5, 1)
    assert not census_cuda.fits(2, 3) and not census_cuda.fits(0, 1)
    assert census_backend("cuda", CARD_TENSOR, 13, 13, 1) == "cuda"
    with pytest.raises(ValueError, match="odd"):
        census_backend("auto", CARD_TENSOR, 8, None, 1)


@pytest.mark.parametrize("fits,want", [(True, "cuda"), (False, "torch")])
def test_auto_takes_the_kernel_only_where_it_fits(fits, want):
    assert resolve_backend("auto", CARD_TENSOR, fits) == want
    assert resolve_backend("auto", CPU_TENSOR, fits) == "torch"


def test_explicit_backends_ignore_the_predicate():
    """An explicit "cuda" is passed on (its launcher raises where the
    kernel does not fit); "torch" always runs the plain version."""
    assert resolve_backend("cuda", CARD_TENSOR, False) == "cuda"
    assert resolve_backend("torch", CARD_TENSOR, True) == "torch"
    with pytest.raises(ValueError, match="CUDA tensors"):
        resolve_backend("cuda", CPU_TENSOR, True)
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas", CPU_TENSOR)


def test_plain_paths_serve_what_the_kernels_refuse_on_the_cpu():
    """D = 600 (SGM, DP), r = 40 (CVF), a 13x13 census (6 code words)
    and a census box sum run on CPU tensors under "auto"; the card tests
    hold the same calls on the card."""
    from stereomatch_tpu_torch import cli_common
    rng = torch.Generator().manual_seed(2)
    left = torch.rand(4, 620, generator=rng)
    right = torch.rand(4, 620, generator=rng)
    for cost, reducer, aggr, kw in (("ssd", "dyn", "sgm", {}),
                                    ("census", "wta", "cvf",
                                     dict(cvf_radius=40)),
                                    ("census", "wta", "sgm",
                                     dict(census_window=13)),
                                    ("census", "wta", "sgm",
                                     dict(kernel_size=2))):
        pipe = cli_common.create_pipeline(cost, reducer, aggr,
                                          max_disparity=600, device="cpu",
                                          **kw)
        disp = pipe.estimate(left, right)
        assert disp.shape == (4, 620) and int(disp.max()) < 600
