"""Calls of the JAX package's public surface that the port takes too.

On the CPU, against the JAX package:

* ``io.load_image(path, grayscale=True)`` and ``load_image(path, True)``
  equal JAX's ``load_image(path, grayscale=True)`` bit for bit on an RGB
  PPM, a grey PGM and an RGB PNG (JAX's PIL path: its native library is
  not built here, whose in-place build races under xdist);
  ``grayscale`` with ``mode`` raises;
* ``ops.cost.zncc_cost_volume(..., eps=e)`` at three ``eps`` on a scene
  with flat patches, so that the variance floor decides cells: bit-equal
  to JAX's XLA volume; ``zncc_cost_from_padded(..., eps=e)`` bands equal
  the whole volume at the same ``eps``;
* ``ops.cost.ssd_cost_from_padded`` and ``sad_cost_from_padded`` over 3
  row bands of a 37x53 D=24 frame at k = 1, 3, 7: the int32 chain
  (uint8 images) bit-equal to JAX's functions of the same names; float32
  bit-equal to the band's rows of JAX's (and the port's)
  ``ssd_cost_volume``/``sad_cost_volume``, which is the contract JAX's
  docstring states.  JAX's own float32 band function departs from it:
  it sums the window as one 2-D ``reduce_window``, whose association
  differs from the separable box of the whole volume in the last places
  (up to 3.8e-5 absolute for SSD and 5.3e-5 for SAD at k = 7, as
  ``python -m tests.test_torch_surface_calls`` prints).  The port's
  band equals the whole volume's rows, as its K1 kernel does on the
  card, and lies within rtol = 4k^2 * 2^-23 of JAX's band (two orders
  of summing the 4k^2 non-negative window terms), with the same +inf
  cells;
* ``utils.profiling.trace`` writes one Chrome-trace JSON naming the
  pipeline's three ``stm/*`` spans, also when its body raises;
  ``annotate_fn`` keeps the name and docstring;
* ``utils.backend.warn_if_backend_init_stalls``: nothing armed for the
  CPU, one line when CUDA is not up, silence when it is (each test joins
  the timer instead of sleeping); the four CLIs arm it through
  ``cli_common.start_device`` with their ``--device``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stereomatch_tpu.native as jax_native
from stereomatch_tpu.io import data as jax_data
from stereomatch_tpu.ops import cost as jax_cost
from stereomatch_tpu_torch import cli_common
from stereomatch_tpu_torch.io import data, png
from stereomatch_tpu_torch.io.synthetic import stereo_pair
from stereomatch_tpu_torch.ops import cost
from stereomatch_tpu_torch.utils import backend, profiling

from .torch_threads import one_torch_thread  # noqa: F401

# --------------------------------------------------------------------------
# io.load_image(grayscale=)
# --------------------------------------------------------------------------


def _write_pnm(path, image):
    magic = b"P6" if image.ndim == 3 else b"P5"
    h, w = image.shape[:2]
    path.write_bytes(magic + f"\n{w} {h}\n255\n".encode() + image.tobytes())


def _image_file(tmp_path, name):
    rng = np.random.default_rng(len(name))
    if name == "grey.pgm":
        image = rng.integers(0, 256, (11, 17)).astype(np.uint8)
    else:
        image = rng.integers(0, 256, (11, 17, 3)).astype(np.uint8)
    path = tmp_path / name
    if name.endswith(".png"):
        png.write(path, image)
    else:
        _write_pnm(path, image)
    return path


@pytest.fixture
def jax_pil_path(monkeypatch):
    monkeypatch.setattr(jax_native, "available", lambda: False)


@pytest.mark.parametrize("name", ["rgb.ppm", "grey.pgm", "rgb.png"])
@pytest.mark.parametrize("call", ["keyword", "positional"])
def test_load_image_grayscale_equals_jax(name, call, tmp_path, jax_pil_path):
    path = _image_file(tmp_path, name)
    want = jax_data.load_image(path, grayscale=True)
    got = (data.load_image(path, grayscale=True) if call == "keyword"
           else data.load_image(path, True))
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data.load_image(path, mode="L"))
    np.testing.assert_array_equal(data.load_image(path, False),
                                  jax_data.load_image(path))


def test_load_image_refuses_grayscale_with_mode(tmp_path):
    path = _image_file(tmp_path, "rgb.ppm")
    with pytest.raises(ValueError, match="both"):
        data.load_image(path, grayscale=True, mode="RGB")
    with pytest.raises(TypeError, match="mode='L'"):
        data.load_image(path, "L")


# --------------------------------------------------------------------------
# ZNCC eps
# --------------------------------------------------------------------------

ZNCC_SHAPE = (24, 40, 8, 3)       # H, W, D, k


def _flat_patch_pair():
    """A synthetic pair with flat patches in both images, placed so that
    the right one is the left one's shifted match: windows inside them
    have no variance, windows at their edges a little."""
    h, w, d, _ = ZNCC_SHAPE
    left, right, _ = stereo_pair(h, w, d, seed=4)
    left, right = left.copy(), right.copy()
    for rows, cols, value in ((slice(2, 12), slice(10, 30), 0.5),
                              (slice(14, 22), slice(3, 18), 0.25)):
        left[rows, cols] = value
        right[rows, slice(cols.start - 2, cols.stop - 2)] = value
    return left, right


@pytest.mark.parametrize("eps", [1e-6, 1e-3, 0.05])
def test_zncc_eps_equals_jax(eps):
    h, w, d, k = ZNCC_SHAPE
    left, right = _flat_patch_pair()
    kw = dict(max_disparity=d, kernel_size=k)
    got = cost.zncc_cost_volume(torch.from_numpy(left),
                                torch.from_numpy(right), eps=eps, **kw)
    want = np.asarray(jax_cost.zncc_cost_volume(left, right, eps=eps, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    # The floor decides cells: more windows take the neutral cost 1 as
    # eps grows, and the default is 1e-6.
    neutral = int((got == 1.0).sum())
    finer = cost.zncc_cost_volume(torch.from_numpy(left),
                                  torch.from_numpy(right), eps=eps / 10, **kw)
    assert neutral > 0 and neutral >= int((finer == 1.0).sum())
    if eps == 1e-6:
        assert torch.equal(got, cost.zncc_cost_volume(
            torch.from_numpy(left), torch.from_numpy(right), **kw))
    else:
        assert not torch.equal(got, cost.zncc_cost_volume(
            torch.from_numpy(left), torch.from_numpy(right), **kw))


@pytest.mark.parametrize("eps", [1e-3, 0.05])
def test_zncc_padded_bands_take_eps(eps):
    h, w, d, k = ZNCC_SHAPE
    left, right = map(torch.from_numpy, _flat_patch_pair())
    whole = cost.zncc_cost_volume(left, right, max_disparity=d,
                                  kernel_size=k, eps=eps)
    bands = []
    for a in (0, h // 2):
        rows = torch.arange(a - k, a + h // 2 + k - 1)
        inside = (rows >= 0) & (rows < h)
        lp, rp = (torch.where(inside[:, None], x[rows.clamp(0, h - 1)], 0.0)
                  for x in (left, right))
        bands.append(cost.zncc_cost_from_padded(
            lp, rp, pad_before=k, pad_after=k - 1, max_disparity=d,
            kernel_size=k, row_valid=inside,
            left_total=cost.image_sum(left),
            right_total=cost.image_sum(right), image_size=h * w, eps=eps))
    assert torch.equal(torch.cat(bands), whole)


# --------------------------------------------------------------------------
# ssd_cost_from_padded / sad_cost_from_padded
# --------------------------------------------------------------------------

BAND_FRAME = (37, 53, 24)
BANDS = ((0, 12), (12, 25), (25, 37))


def _band_case(dtype, seed=6):
    h, w, _ = BAND_FRAME
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (h, w)).astype(np.uint8)
    right = rng.integers(0, 256, (h, w)).astype(np.uint8)
    if dtype == "float32":
        left = left.astype(np.float32) / 255
        right = right.astype(np.float32) / 255
    return left, right


@pytest.mark.parametrize("name", ["ssd", "sad"])
@pytest.mark.parametrize("k", [1, 3, 7])
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_padded_band_costs(name, k, dtype):
    h, _, d = BAND_FRAME
    left, right = _band_case(dtype)
    kw = dict(max_disparity=d, kernel_size=k)
    jkw = dict(kw, cost_dtype=getattr(jnp, dtype))
    tkw = dict(kw, cost_dtype=getattr(torch, dtype))
    jax_band = getattr(jax_cost, f"{name}_cost_from_padded")
    port_band = getattr(cost, f"{name}_cost_from_padded")
    whole = np.asarray(getattr(jax_cost, f"{name}_cost_volume")(
        left, right, **jkw))
    np.testing.assert_array_equal(whole, getattr(cost, f"{name}_cost_volume")(
        torch.from_numpy(left), torch.from_numpy(right), **tkw).numpy())
    for a, b in BANDS:
        pb, pa = min(k, a), min(k - 1, h - b)
        lp, rp = left[a - pb:b + pa], right[a - pb:b + pa]
        got = port_band(torch.from_numpy(lp), torch.from_numpy(rp),
                        pad_before=pb, pad_after=pa, **tkw)
        assert got.is_contiguous() and got.shape == (b - a, 53, d)
        got = got.numpy()
        want = np.asarray(jax_band(lp, rp, pad_before=pb, pad_after=pa,
                                   **jkw))
        np.testing.assert_array_equal(got, whole[a:b])
        if dtype == "int32":
            np.testing.assert_array_equal(got, want)
            assert (got[:, np.arange(53)[:, None] < np.arange(d)] ==
                    np.iinfo(np.int32).max).all()
        else:
            assert np.array_equal(np.isinf(got), np.isinf(want))
            fin = np.isfinite(want)
            np.testing.assert_allclose(got[fin], want[fin],
                                       rtol=4 * k * k * 2.0 ** -23, atol=0)


def test_padded_band_refusals():
    left, right = map(torch.from_numpy, _band_case("float32"))
    with pytest.raises(ValueError, match="halos"):
        cost.ssd_cost_from_padded(left, right, pad_before=4, pad_after=0,
                                  max_disparity=8, kernel_size=3)
    with pytest.raises(ValueError, match="halos"):
        cost.sad_cost_from_padded(left, right, pad_before=0, pad_after=3,
                                  max_disparity=8, kernel_size=3)
    with pytest.raises(ValueError, match="CUDA"):
        cost.ssd_cost_from_padded(left, right, pad_before=3, pad_after=2,
                                  max_disparity=8, kernel_size=3,
                                  backend="cuda")


# --------------------------------------------------------------------------
# utils.profiling
# --------------------------------------------------------------------------

SPANS = ("stm/cost", "stm/aggregation", "stm/disparity_reduce")


def _trace_names(log_dir):
    files = list(log_dir.glob("*.json"))
    assert len(files) == 1, files
    events = json.loads(files[0].read_text())["traceEvents"]
    return {str(e.get("name")) for e in events}


def test_trace_names_the_pipeline_spans(tmp_path):
    left, right, _ = stereo_pair(37, 53, 16, seed=1)
    pipe = cli_common.create_pipeline("ssd", "wta", "sgm", max_disparity=16,
                                      device="cpu")
    with profiling.trace(tmp_path / "trace"):
        disp = pipe.estimate(left, right)
    assert disp.shape == (37, 53)
    names = _trace_names(tmp_path / "trace")
    assert set(SPANS) <= names


def test_trace_writes_when_the_body_raises(tmp_path, capsys):
    with pytest.raises(RuntimeError, match="inside"):
        with profiling.trace(tmp_path, create_perfetto_link=True):
            with profiling.annotate("stm/test-span"):
                torch.ones(4).sum()
            raise RuntimeError("inside the capture")
    assert "stm/test-span" in _trace_names(tmp_path)
    out = capsys.readouterr().out
    assert str(tmp_path) in out and "ui.perfetto.dev" in out


def test_annotate_fn_keeps_name_and_doc(tmp_path):
    @profiling.annotate_fn()
    def stage(x):
        """Doubles x."""
        return 2 * x

    @profiling.annotate_fn("stm/named")
    def other(x):
        return x + 1

    assert stage.__name__ == "stage" and stage.__doc__ == "Doubles x."
    with profiling.trace(tmp_path):
        assert stage(3) == 6 and other(1) == 2
    assert {"stage", "stm/named"} <= _trace_names(tmp_path)


# --------------------------------------------------------------------------
# The CUDA start watchdog
# --------------------------------------------------------------------------


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_watchdog_arms_nothing_for_the_cpu(device):
    assert backend.warn_if_backend_init_stalls(0.01, device=device) is None
    assert cli_common.start_device(device) is None


@pytest.mark.parametrize("up", [False, True])
def test_watchdog_fires_once_only_when_cuda_is_down(up, monkeypatch,
                                                    capsys):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: up)
    timer = backend.warn_if_backend_init_stalls(0.01, device="cuda")
    assert timer is not None and timer.daemon
    timer.join()
    err = capsys.readouterr().err
    if up:
        assert err == ""
    else:
        lines = err.splitlines()
        assert len(lines) == 1
        assert "still initializing the CUDA runtime after 0.01 s" in lines[0]
        assert "--device cpu" in lines[0]


def test_start_device_starts_cuda_at_once(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "init", lambda: calls.append("init"))
    timer = cli_common.start_device("cuda")
    timer.cancel()
    timer.join()
    assert calls == ["init"]


def test_start_device_raises_when_cuda_fails(monkeypatch):
    """A failed start raises as it did before the watchdog, which is
    cancelled with it: a hint, not a fallback."""
    def fail():
        raise RuntimeError("no CUDA device")
    timers = []
    arm = backend.warn_if_backend_init_stalls
    monkeypatch.setattr(torch.cuda, "init", fail)
    monkeypatch.setattr(backend, "warn_if_backend_init_stalls",
                        lambda **kw: timers.append(arm(**kw)) or timers[-1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_common.start_device("cuda")
    timers[0].join()
    assert not timers[0].is_alive() and timers[0].finished.is_set()


class _Armed(Exception):
    pass


def _cli_argv(name, tmp_path):
    if name == "image":
        left, right, _ = stereo_pair(16, 24, 4, seed=1)
        png.write(tmp_path / "l.png", (left * 255).astype(np.uint8))
        png.write(tmp_path / "r.png", (right * 255).astype(np.uint8))
        return [str(tmp_path / "l.png"), str(tmp_path / "r.png"), "4",
                str(tmp_path / "out.png")]
    if name == "video":
        return ["imgdir", str(tmp_path), "4", "--headless"]
    if name == "evaluate":
        return ["--synthetic", "1", "--synthetic-size", "16x24x4"]
    return ["4", "--port", "0"]


@pytest.mark.parametrize("name", ["image", "video", "evaluate", "serve"])
@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_every_cli_arms_the_watchdog(name, device, tmp_path, monkeypatch):
    """Each CLI hands its ``--device`` to ``cli_common.start_device``
    after its arguments are checked and before any other work."""
    import importlib
    main = importlib.import_module(f"stereomatch_tpu_torch.cli.{name}").main
    armed = []

    def start(dev):
        armed.append(dev)
        raise _Armed

    monkeypatch.setattr(cli_common, "start_device", start)
    with pytest.raises(_Armed):
        main([*_cli_argv(name, tmp_path), "--device", device])
    assert armed == [device]


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python -m tests.test_torch_surface_calls: how far
    # JAX's float32 band functions depart from JAX's own whole volume on
    # this file's bands (the share of cells that differ, the largest
    # absolute difference).
    h, _, d = BAND_FRAME
    left, right = _band_case("float32")
    for name in ("ssd", "sad"):
        for k in (1, 3, 7):
            kw = dict(max_disparity=d, kernel_size=k)
            whole = np.asarray(getattr(jax_cost, f"{name}_cost_volume")(
                left, right, **kw))
            for a, b in BANDS:
                pb, pa = min(k, a), min(k - 1, h - b)
                band = np.asarray(getattr(jax_cost,
                                          f"{name}_cost_from_padded")(
                    left[a - pb:b + pa], right[a - pb:b + pa],
                    pad_before=pb, pad_after=pa, **kw))
                fin = np.isfinite(whole[a:b])
                diff = np.abs(band[fin] - whole[a:b][fin])
                print(f"{name} k={k} rows {a}-{b}: {np.mean(diff > 0):.4f} "
                      f"of cells differ, max {diff.max():.3g}")
