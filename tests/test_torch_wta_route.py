"""Where a frame takes winner-takes-all inside SGM's last launch, on the
CPU with no card.

``Pipeline.estimate_fn`` (and so ``compiled()``, the graph a stream
replays) reads no volume, so a ``Semiglobal`` aggregation reduced by
``WinnerTakesAll`` takes the argmin in the fold
(``Semiglobal.winner_takes_all``) where the kernels take the
side-by-side form.  Each case asks the SGM stage what it decides for a
volume of a given shape on the card (or on the CPU), then runs one entry
point on a small CPU frame with that answer and the fused call replaced
by its plain equal: the frame fuses exactly where the stage does, the
reducer is winner-takes-all and the entry reads no volume, and gives the
volume route's disparities either way.
"""

from types import SimpleNamespace

import pytest
import torch

from stereomatch_tpu_torch import cli_common
from stereomatch_tpu_torch.aggregation import Semiglobal
from stereomatch_tpu_torch.io.synthetic import stereo_pair
from stereomatch_tpu_torch.ops import sgm_cuda
from stereomatch_tpu_torch.ops.aggregation import semiglobal_aggregate
from stereomatch_tpu_torch.ops.disparity import winner_takes_all

from .torch_threads import one_torch_thread  # noqa: F401

TEDDY = (375, 450, 128)
KITTI = (375, 1242, 128)
CENSUS_9X7 = dict(census_window=9, census_height=7, adaptive_p2=False,
                  penalty1=10, penalty2=120)

# What each entry point returns, from (pipeline, left, right); the first
# two read no volume.
ENTRIES = {
    "estimate_fn": lambda p, l, r: p.estimate_fn()(l, r),
    "compiled": lambda p, l, r: p.compiled()(l, r),
    "estimate": lambda p, l, r: p.estimate(l, r),
    "estimate_refined": lambda p, l, r: p.estimate_refined(l, r),
    "estimate_refined_lr": lambda p, l, r: p.estimate_refined(
        l, r, lr_check=True, subpixel=False, median=False),
    "last_confidence": lambda p, l, r: (p.estimate(l, r),
                                        p.last_confidence())[1],
}
READ_NO_VOLUME = ("estimate_fn", "compiled")

# (id, create_pipeline's names and keywords, the volume's shape, on the
# card, entry point, whether an SGM stage fuses at that shape and device:
# False where there is none).
ROUTES = [
    ("teddy ssd+sgm+wta", ("ssd", "wta", "sgm"), {}, TEDDY, True,
     "estimate_fn", True),
    ("teddy graph", ("ssd", "wta", "sgm"), {}, TEDDY, True, "compiled",
     True),
    ("kitti census 9x7 constant P2", ("census", "wta", "sgm"), CENSUS_9X7,
     KITTI, True, "compiled", True),
    ("teddy bf16", ("ssd", "wta", "sgm"), dict(volume_dtype="bfloat16"),
     TEDDY, True, "estimate_fn", True),
    ("37x53 D=37", ("ssd", "wta", "sgm"), {}, (37, 53, 37), True,
     "estimate_fn", True),
    ("dp", ("ssd", "dyn", "sgm"), {}, TEDDY, True, "estimate_fn", True),
    ("cvf", ("census", "wta", "cvf"), {}, TEDDY, True, "estimate_fn",
     False),
    ("no aggregation", ("ssd", "wta", None), {}, TEDDY, True, "compiled",
     False),
    ("backend torch", ("ssd", "wta", "sgm"), dict(backend="torch"), TEDDY,
     True, "estimate_fn", False),
    ("hd D=256 serial form", ("ssd", "wta", "sgm"), {}, (1024, 1280, 256),
     True, "compiled", False),
    ("D=600 past the kernels", ("ssd", "wta", "sgm"), {}, (64, 704, 600),
     True, "estimate_fn", False),
    ("the cpu", ("ssd", "wta", "sgm"), {}, TEDDY, False, "compiled",
     False),
    ("estimate", ("ssd", "wta", "sgm"), {}, TEDDY, True, "estimate", True),
    ("estimate_refined", ("ssd", "wta", "sgm"), {}, TEDDY, True,
     "estimate_refined", True),
    ("estimate_refined lr mirror", ("ssd", "wta", "sgm"), {}, TEDDY, True,
     "estimate_refined_lr", True),
    ("last_confidence", ("ssd", "wta", "sgm"), {}, TEDDY, True,
     "last_confidence", True),
]


@pytest.mark.parametrize("names,kw,shape,on_card,entry,stage_fuses",
                         [case[1:] for case in ROUTES],
                         ids=[case[0] for case in ROUTES])
def test_a_frame_fuses_wta_into_sgm_only_where_nothing_reads_the_volume(
        monkeypatch, names, kw, shape, on_card, entry, stage_fuses):
    def build():
        return cli_common.create_pipeline(*names, max_disparity=8,
                                          device="cpu", **kw)

    pipe = build()
    volume = SimpleNamespace(shape=torch.Size(shape), is_cuda=on_card)
    if isinstance(pipe.aggregation, Semiglobal):
        assert pipe.aggregation._fuses_wta(volume) == stage_fuses
        monkeypatch.setattr(pipe.aggregation, "_fuses_wta",
                            lambda _: stage_fuses)
    else:
        assert not stage_fuses

    fused = []

    def plain_wta(cost_volume, left_image, **penalties):
        fused.append(tuple(cost_volume.shape))
        return winner_takes_all(semiglobal_aggregate(cost_volume, left_image,
                                                     **penalties))

    monkeypatch.setattr(sgm_cuda, "semiglobal_wta_cuda", plain_wta)
    left, right, _ = stereo_pair(16, 24, 8, seed=5)
    left, right = torch.from_numpy(left), torch.from_numpy(right)
    got = ENTRIES[entry](pipe, left, right)
    frame_fuses = (stage_fuses and names[1] == "wta"
                   and entry in READ_NO_VOLUME)
    assert fused == ([(16, 24, 8)] if frame_fuses else [])
    want = ENTRIES[entry](build(), left, right)
    assert got.dtype == want.dtype and torch.equal(got, want)
