"""The CUDA kernels' launchers and dispatch, on a machine without a card.

No kernel can build or run here.  What can be held: a CPU tensor never
reaches a kernel (backend="auto" takes the plain version, backend="cuda"
raises), the plain path leaves the launch counters at 0, the launchers
refuse CPU tensors, and importing the build module needs no nvcc until a
build is asked for.
"""

import collections
import importlib

import pytest
import torch

from stereomatch_tpu_torch import cli_common
from stereomatch_tpu_torch.aggregation import CostFilter, Semiglobal
from stereomatch_tpu_torch.cost import SAD, SSD, Census
from stereomatch_tpu_torch.disparity_reduce import DynamicProgramming
from stereomatch_tpu_torch.io.synthetic import stereo_pair
from stereomatch_tpu_torch.ops import (_build, census_cuda, cvf_cuda, dp_cuda,
                                       sgm_cuda, ssd_cuda)
from stereomatch_tpu_torch.ops import cost as cost_ops
from stereomatch_tpu_torch.ops.aggregation import TRAVERSALS
from stereomatch_tpu_torch.utils.backend import resolve_backend

@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", collections.Counter())


def _all_zero():
    """No entry point of any kernel, of either dtype, was launched."""
    return sum(_build.LAUNCHES.values()) == 0


def test_resolve_backend():
    cpu = torch.zeros(1)
    assert resolve_backend("auto", cpu) == "torch"
    assert resolve_backend("torch", cpu) == "torch"
    with pytest.raises(ValueError, match="CUDA tensors"):
        resolve_backend("cuda", cpu)
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas", cpu)


@pytest.mark.parametrize("stage", ["ssd", "sad", "sgm", "cvf", "dyn",
                                   "census", "census_volume"])
def test_cuda_backend_on_cpu_tensors_raises(stage, counters):
    left = torch.rand(8, 12)
    vol = torch.rand(8, 12, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        if stage == "census":
            Census(4, 9, window_height=7, backend="cuda")(left, left)
        elif stage == "census_volume":
            cost_ops.census_hamming_cost_volume(left, left, max_disparity=4,
                                                backend="cuda")
        elif stage == "sgm":
            Semiglobal(backend="cuda")(vol, left)
        elif stage == "cvf":
            CostFilter(backend="cuda", wedge_offset=0)(vol, left)
        elif stage == "dyn":
            DynamicProgramming(backend="cuda")(vol)
        else:
            (SSD if stage == "ssd" else SAD)(4, backend="cuda")(left, left)
    assert _all_zero()


def test_plain_path_launches_no_kernel(counters):
    left, right, _ = stereo_pair(24, 40, 8, seed=4)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=8)
    pipe.estimate(left, right, device="cpu")
    assert _all_zero()


@pytest.mark.parametrize("cost,aggr,reducer", [
    ("ssd", "sgm", "dyn"), ("census", "cvf", "wta"), ("census", "cvf", "dyn")])
def test_new_plain_paths_launch_no_kernel(counters, cost, aggr, reducer):
    left, right, _ = stereo_pair(24, 40, 8, seed=4)
    pipe = cli_common.create_pipeline(cost, reducer, aggr, max_disparity=8)
    pipe.estimate(left, right, device="cpu")
    assert _all_zero()


@pytest.mark.parametrize("window", [(5, None), (9, 7), (11, 11), (13, 13)],
                         ids=str)
@pytest.mark.parametrize("kernel_size", [1, 3])
def test_census_on_cpu_tensors_launches_nothing(counters, window,
                                                kernel_size):
    """Under "auto" the census of CPU tensors runs the plain version,
    whether or not the kernels would serve its window and box sum, and
    equals the plain functions called directly."""
    left, right, _ = stereo_pair(12, 30, 6, seed=5)
    left, right = torch.from_numpy(left), torch.from_numpy(right)
    size, height = window
    want = cost_ops.census_hamming_from_codes(
        cost_ops.census_transform(left, size, height),
        cost_ops.census_transform(right, size, height), max_disparity=6,
        kernel_size=kernel_size)
    got = Census(6, size, kernel_size, window_height=height)(left, right)
    vol = cost_ops.census_hamming_cost_volume(
        left, right, max_disparity=6, window_size=size,
        window_height=height, kernel_size=kernel_size)
    assert torch.equal(got, want) and torch.equal(vol, want)
    assert _all_zero()


@pytest.mark.parametrize("call", ["census", "census_volume"])
def test_census_takes_no_unknown_backend(counters, call):
    left = torch.rand(8, 12)
    with pytest.raises(ValueError, match="unknown backend"):
        if call == "census":
            Census(4, backend="pallas")(left, left)
        else:
            cost_ops.census_hamming_cost_volume(left, left, max_disparity=4,
                                                backend="xla")
    assert _all_zero()


@pytest.mark.parametrize("backend", ["auto", "cuda", "torch"])
def test_create_pipeline_hands_its_backend_to_census(backend):
    pipe = cli_common.create_pipeline("census", "wta", "sgm", max_disparity=8,
                                      census_window=9, census_height=7,
                                      backend=backend, device="cpu")
    assert isinstance(pipe.cost, Census) and pipe.cost.backend == backend
    assert pipe.aggregation.backend == backend


@pytest.mark.parametrize("window", [(5, None), (9, 7)], ids=str)
def test_census_routes_run_the_plain_steps_or_the_launchers(counters,
                                                            window):
    """census_codes and census_hamming on the "torch" route are the plain
    steps; on the "cuda" route they are the launchers, which refuse CPU
    tensors, so the route alone picks the implementation."""
    left, right, _ = stereo_pair(10, 24, 5, seed=8)
    left, right = torch.from_numpy(left), torch.from_numpy(right)
    codes = cost_ops.census_codes(left, right, *window, route="torch")
    for got, image in zip(codes, (left, right)):
        assert torch.equal(got, cost_ops.census_transform(image, *window))
    kw = dict(max_disparity=5, cost_dtype=torch.int32, disparity_offset=2)
    assert torch.equal(
        cost_ops.census_hamming(*codes, route="torch", **kw),
        cost_ops.census_hamming_from_codes(*codes, **kw))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cost_ops.census_codes(left, right, *window, route="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        cost_ops.census_hamming(*codes, route="cuda", **kw)
    assert _all_zero()


def test_census_launchers_refuse_cpu_tensors(counters):
    left = torch.rand(6, 9)
    with pytest.raises(ValueError, match="CUDA tensors"):
        census_cuda.census_codes_cuda(left, left, 9, 7)
    codes = torch.zeros(6, 9, 2, dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        with pytest.raises(ValueError, match="CUDA tensors"):
            census_cuda.census_hamming_from_codes_cuda(
                codes, codes, max_disparity=4, cost_dtype=dtype)
    assert _all_zero()


def test_launchers_refuse_cpu_tensors(counters):
    left = torch.rand(6, 9)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssd_cuda.diff_cost_volume_cuda(left, left, max_disparity=4,
                                       kernel_size=2,
                                       cost_dtype=torch.float32,
                                       absolute=False)
    vol = torch.rand(6, 9, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sgm_cuda.semiglobal_aggregate_cuda(vol, left)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sgm_cuda.traverse_cuda(vol, left, torch.empty_like(vol), (0, 1),
                               0.1, 0.2, accumulate=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dp_cuda.dp_forward_cuda(vol)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dp_cuda.dp_backward_cuda(torch.zeros(6, 9, 4, dtype=torch.int8),
                                 torch.zeros(6, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        cvf_cuda.guided_filter_aggregate_cuda(vol, left, wedge_offset=0)
    assert _all_zero()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32], ids=str)
def test_dp_forward_takes_every_volume_dtype(counters, monkeypatch, dtype):
    """The forward launcher hands float32 and bf16 volumes to its checks
    as they are and widens the int32 chain's to float32, as the plain
    version does; a CPU tensor then fails the device check, before any
    launch."""
    checked = []
    check = dp_cuda._check_volume

    def spy(name, t, dtypes):
        checked.append(t.dtype)
        check(name, t, dtypes)

    monkeypatch.setattr(dp_cuda, "_check_volume", spy)
    vol = torch.ones(6, 9, 4, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA tensors"):
        dp_cuda.dp_forward_cuda(vol)
    assert checked == [torch.float32 if dtype == torch.int32 else dtype]
    assert _all_zero()


def test_cvf_launch_function_refuses_cpu_tensors(counters):
    """The two CVF launches on precomputed guide planes (what chip_smoke.py
    times alone) refuse CPU tensors and count nothing."""
    from stereomatch_tpu_torch.ops.cvf import guide_planes
    vol = torch.rand(6, 9, 4)
    planes = guide_planes(torch.rand(6, 9), 2, 0, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cvf_cuda._launch_kernels(vol, planes, 2, 1e-4, 0)
    assert _all_zero()


def test_build_module_needs_nvcc_only_for_a_build(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    build = importlib.reload(_build)              # importing: no nvcc needed
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", tmp_path / "no-cuda")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build()
    assert not (tmp_path / "build").exists()


def test_build_key_follows_sources_and_flags():
    key = _build._key()
    assert key == _build._key() and len(key) == 16
    names = {p.name for p in _build._sources()}
    assert {"ssd.cu", "sgm.cu", "dp.cu", "cvf.cu", "census.cu",
            "cp_async.cuh"} <= names
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_every_c_entry_point_is_declared():
    """Each extern "C" function of csrc/*.cu has a ctypes signature whose
    argument count matches its C parameter list."""
    import re
    declared = {}
    for src in _build._sources():
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src.read_text()):
            declared[name] = len(params.split(","))
    assert declared.keys() == _build._SIGNATURES.keys()
    assert {"stm_census_codes", "stm_census_hamming_f32",
            "stm_census_hamming_i32", "stm_census_hamming_bf16"} <= set(
                declared)
    for name, n_args in declared.items():
        assert len(_build._SIGNATURES[name]) == n_args, name


@pytest.mark.parametrize("step", TRAVERSALS, ids=str)
def test_sgm_launchers_refuse_cpu_tensors_for_every_traversal(counters,
                                                              step):
    """Each traversal's launcher, the chunk kernel's for the row ones,
    refuses CPU tensors before a launch and counts nothing."""
    vol, left = torch.rand(6, 9, 4), torch.rand(6, 9)
    with pytest.raises(ValueError, match="CUDA tensors"):
        sgm_cuda.traverse_cuda(vol, left, torch.empty_like(vol), step, 0.1,
                               0.2, accumulate=False)
    if step[0] != 0:
        with pytest.raises(ValueError, match="CUDA tensors"):
            sgm_cuda.sweep_chunk_with_carry_cuda(vol, left, step,
                                                 penalty1=0.1, penalty2=0.2,
                                                 seed=True)
    assert _all_zero()


# The two forms of sgm_cuda.semiglobal_aggregate_cuda, float32 on an
# H100 (CUDA events, median of 20; PERF.md §6): [H, W, D] -> (serial,
# side by side) ms.  The rule must take the faster at each.
SGM_FORM_TIMES = {(375, 450, 128): (1.0352, 0.7933),
                  (375, 450, 256): (1.6854, 1.5900),
                  (480, 640, 128): (1.5451, 1.3848),
                  (375, 1242, 128): (2.2957, 1.9985),
                  (540, 960, 128): (2.4101, 2.2344),
                  (720, 1280, 128): (4.3734, 4.1839),
                  (1024, 1280, 128): (6.2734, 5.9916),
                  (1024, 1280, 256): (11.7737, 12.1983)}


def test_sgm_form_rule_takes_side_by_side_at_teddy():
    """Teddy's six partial volumes, 518 MB, fit the bound."""
    assert sgm_cuda._takes_side_by_side(375, 450, 128)


def test_sgm_form_rule_takes_serial_at_hd():
    """At 1024x1280 D=256 the partials would take 7.5 GiB, and the serial
    form measured faster."""
    assert not sgm_cuda._takes_side_by_side(1024, 1280, 256)


@pytest.mark.parametrize("shape", sorted(SGM_FORM_TIMES), ids=str)
def test_sgm_form_rule_takes_the_form_measured_faster(shape):
    serial_ms, side_ms = SGM_FORM_TIMES[shape]
    assert sgm_cuda._takes_side_by_side(*shape) == (side_ms < serial_ms)


SGM_RULE_CASES = [(h, w, d) for h, w in ((1, 1), (48, 80), (375, 450),
                                         (1024, 1280), (2160, 3840))
                  for d in (1, 16, 33, 128, 256, 512)]


def test_sgm_form_rule_reads_nothing_but_the_shape(monkeypatch):
    """The rule asks no device, environment or state: the same shape gives
    the same form, with every device query broken; a larger frame never
    turns a serial shape side by side."""
    def refuse(*args, **kwargs):
        raise AssertionError("the rule queried the device")
    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    first = [sgm_cuda._takes_side_by_side(*c) for c in SGM_RULE_CASES]
    assert first == [sgm_cuda._takes_side_by_side(*c)
                     for c in SGM_RULE_CASES]
    for (h, w, d), side in zip(SGM_RULE_CASES, first):
        if not side:
            assert not sgm_cuda._takes_side_by_side(2 * h, w, d)
            assert not sgm_cuda._takes_side_by_side(h, 2 * w, d)
            assert not sgm_cuda._takes_side_by_side(h, w, 2 * d)


@pytest.mark.parametrize("shape", SGM_RULE_CASES, ids=str)
def test_sgm_form_rule_bounds_the_scratch(shape):
    """The side-by-side form is taken exactly where its six float32
    partial volumes fit ``SIDE_BY_SIDE_SCRATCH_BYTES``."""
    h, w, d = shape
    scratch = 6 * h * w * d * 4
    assert sgm_cuda._side_by_side_scratch_bytes(h, w, d) == scratch
    assert sgm_cuda._takes_side_by_side(h, w, d) == (
        scratch <= sgm_cuda.SIDE_BY_SIDE_SCRATCH_BYTES)
