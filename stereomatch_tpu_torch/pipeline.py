"""Stereo-matching pipeline composition: cost -> optional aggregation ->
reduce, counterpart of ``stereomatch_tpu/pipeline.py``.

PyTorch runs eagerly: each stage launches its kernels on the current
CUDA stream, and the stages share the caching allocator's buffers from
frame to frame.  ``estimate_refined`` adds the post-processing stages of
``ops/refine.py`` in the JAX package's order, and ``last_confidence``
the PKRN confidence of the last run.  An ``SSDTexture`` cost gets its
plain tensors wrapped as textures, as in the JAX package (the
reference's ``_TexCostFunctionWrapper``, pipeline.py:22-33).

``compiled()`` is the counterpart of the JAX package's whole-pipeline
``jax.jit``: on the card, a CUDA graph of one frame per input shape,
dtype and device (:class:`CompiledPipeline`), replayed with one host
call where the eager frame makes one launch for each kernel and
PyTorch operation.

``estimate_fn``, and so ``compiled()``, returns the disparity alone, so
nothing reads the aggregated volume there: a ``Semiglobal`` aggregation
reduced by ``WinnerTakesAll``, on the kernels at a shape where they take
the side-by-side form, takes the argmin in SGM's last launch
(``Semiglobal.winner_takes_all``) and writes no volume.  The
``disparity_reduce`` stage is then empty.  ``estimate`` and
``estimate_refined`` keep the volume, which ``last_confidence``,
sub-pixel refinement and the LR check read.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .cost import SSDTexture
from .disparity_reduce import WinnerTakesAll
from .ops import _build
from .texture import TextureImage
from .utils import profiling, validation

Image = Union[torch.Tensor, np.ndarray]
Device = Union[str, torch.device, None]


def tensor_from_numpy(array: np.ndarray) -> torch.Tensor:
    """A tensor holding a copy of ``array`` (it may be read-only, a
    tensor never is).  A bfloat16 array (``ml_dtypes.bfloat16``, as JAX
    gives it), which ``torch.from_numpy`` refuses, crosses as its 16-bit
    patterns and is viewed as ``torch.bfloat16``: the same values."""
    array = np.array(array, order="C")
    if array.dtype.name == "bfloat16":
        return torch.from_numpy(array.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(array)


def host_array(array) -> np.ndarray:
    """A numpy array of a tensor (copied to the host) or of anything
    ``np.asarray`` takes."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def as_tensor(image: Image, device: Device = None) -> torch.Tensor:
    """A tensor on ``device`` (None: where it is, the CPU for a numpy
    array), numpy array or tensor alike.  ``"cuda"`` on a machine
    without a GPU raises, as ``Tensor.to`` does: there is no fallback to
    the CPU."""
    if isinstance(image, np.ndarray):
        image = tensor_from_numpy(image)
    return image if device is None else image.to(device)


def disparity_bins(disparity: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Disparities rounded (half to even) and clipped into [0, max_disp),
    as int64 indices of the D axis."""
    if disparity.is_floating_point():
        disparity = disparity.round()
    return disparity.clamp(0, max_disp - 1).to(torch.int64)


class _TexCostFunctionWrapper:
    """Wraps an SSDTexture cost so the pipeline can feed it tensors."""

    def __init__(self, cost_function: SSDTexture):
        self.cost_function = cost_function

    @property
    def max_disparity(self) -> int:
        return self.cost_function.max_disparity

    @max_disparity.setter
    def max_disparity(self, value: int) -> None:
        self.cost_function.max_disparity = value

    def __call__(self, left_image, right_image, cost_volume=None):
        return self.cost_function(TextureImage.from_array(left_image),
                                  TextureImage.from_array(right_image),
                                  cost_volume=cost_volume)


class Pipeline:
    """Composable stereo pipeline: cost -> optional aggregation -> reduce
    (reference: stereomatch/pipeline.py:36-94)."""

    def __init__(self, cost: Callable, disparity_reduce: Callable,
                 aggregation: Optional[Callable] = None,
                 device: Device = "cuda"):
        """
        Args:
            cost: callable (left, right) -> [H, W, D] cost volume.
            disparity_reduce: callable (volume) -> [H, W] int32 disparity.
            aggregation: optional callable (volume, left_image) -> volume.
            device: where ``estimate`` runs when its own ``device=`` is
              not given: the card by default; ``"cpu"`` runs the plain
              PyTorch versions on the CPU.
        """
        if isinstance(cost, SSDTexture):
            cost = _TexCostFunctionWrapper(cost)
        self.cost = cost
        self.disparity_reduce = disparity_reduce
        self.aggregation = aggregation
        self.device = device

        # Diagnostic captures of the last run's intermediates, matching
        # the reference's reusable-buffer attributes (pipeline.py:65-67).
        self._cost_volume = None
        self._aggregation_volume = None
        self._disparity_image = None

    @property
    def _stage(self) -> Optional[str]:
        """The stage this thread's last run entered ("cost",
        "aggregation", "disparity_reduce"): a failed CUDA graph capture
        names it."""
        return profiling.last_stage()

    def _run(self, left_image: torch.Tensor, right_image: torch.Tensor,
             fuse: bool = False):
        """(cost volume, aggregated volume, disparity) of one frame.  With
        ``fuse``, a ``WinnerTakesAll`` reducer takes the disparity from
        the aggregation's ``winner_takes_all`` where that gives one
        (``Semiglobal``'s, in SGM's last launch), and the aggregated
        volume is None."""
        # Stage spans show up in torch.profiler captures, and stamps on
        # the card while one records (utils/profiling.py).
        device = left_image.device
        with profiling.stage("cost", device):
            cost_volume = self.cost(left_image, right_image)
        fused = (getattr(self.aggregation, "winner_takes_all", None)
                 if fuse and isinstance(self.disparity_reduce, WinnerTakesAll)
                 else None)
        aggregation_volume = disparity = None
        if self.aggregation is None:
            aggregation_volume = cost_volume
        else:
            with profiling.stage("aggregation", device):
                if fused is not None:
                    disparity = fused(cost_volume, left_image)
                if disparity is None:
                    aggregation_volume = self.aggregation(cost_volume,
                                                          left_image)
        with profiling.stage("disparity_reduce", device):
            if disparity is None:   # else taken in the aggregation
                disparity = self.disparity_reduce(aggregation_volume)
        return cost_volume, aggregation_volume, disparity

    def estimate(self, left_image: Image, right_image: Image,
                 device: Device = None) -> torch.Tensor:
        """Run the pipeline; returns an int32 [H, W] disparity tensor on
        ``device``, else on ``self.device`` (the card unless the pipeline
        was built for the CPU).  Images, numpy or tensors, go there."""
        device = device if device is not None else self.device
        left_image = as_tensor(left_image, device)
        right_image = as_tensor(right_image, device)
        validation.check_stereo_pair(left_image, right_image)
        (self._cost_volume, self._aggregation_volume,
         self._disparity_image) = self._run(left_image, right_image)
        return self._disparity_image

    def estimate_refined(self, left_image: Image, right_image: Image, *,
                         subpixel: bool = True, median: bool = True,
                         lr_check: bool = False, lr_mode: str = "mirror",
                         max_diff: int = 1, weighted_median: bool = False,
                         wmf_sigma: float = 10.0, wmf_window: int = 5,
                         fgs_lambda: Optional[float] = None,
                         fgs_sigma: float = 8.0,
                         min_confidence: Optional[float] = None,
                         device: Device = None) -> torch.Tensor:
        """Estimate and post-process, as the JAX package's
        ``Pipeline.estimate_refined`` does, stage by stage in its order:

        * ``lr_check``: the left-right check (``max_diff``) with the
          background occlusion fill; the right disparity comes from the
          pipeline run again on the mirrored pair (``lr_mode="mirror"``)
          or from the aggregated volume re-indexed into the right view
          (``"volume"``);
        * ``weighted_median``: the guide-weighted median, the left image
          the guide (``wmf_sigma`` in its intensity units,
          ``wmf_window``);
        * ``median``: the 3x3 median;
        * ``subpixel``: parabolic sub-pixel interpolation on the
          aggregated volume (float32 from here on);
        * ``fgs_lambda``: the fast global smoother (``fgs_sigma``),
          confidence-weighted by the LR mask when ``lr_check`` is on;
        * ``min_confidence``: pixels whose PKRN confidence is below it
          become 0, the Middlebury unknown.

        Runs on ``device``, else ``self.device``; see ``ops/refine.py``.
        """
        from .ops import refine

        if lr_mode not in ("mirror", "volume"):
            raise ValueError(f"unknown lr_mode: {lr_mode!r}")
        device = device if device is not None else self.device
        left_image = as_tensor(left_image, device)
        right_image = as_tensor(right_image, device)
        disp_r = None
        if lr_check and lr_mode == "mirror":
            validation.check_stereo_pair(left_image, right_image)
            disp_r = refine.right_disparity(
                lambda l, r: self._run(l, r)[2], left_image, right_image)
        disp = self.estimate(left_image, right_image, device=device)
        max_disp = self._aggregation_volume.shape[2]
        if lr_check:
            if disp_r is None:
                disp_r = refine.right_disparity_from_volume(
                    self._aggregation_volume)
            mask = refine.left_right_consistency(disp, disp_r, max_diff,
                                                 max_disparity=max_disp)
            disp = refine.fill_inconsistent(disp, mask)
        if weighted_median:
            disp = refine.weighted_median_filter(
                disp, left_image, window=wmf_window, sigma=wmf_sigma,
                n_bins=max_disp)
        if median:
            disp = refine.median_filter_3x3(disp)
        if subpixel:
            disp = refine.subpixel_refine(self._aggregation_volume,
                                          disparity_bins(disp, max_disp))
        if fgs_lambda is not None:
            conf = mask.to(torch.float32) if lr_check else None
            disp = refine.fgs_smooth(disp.to(torch.float32), left_image,
                                     lam=fgs_lambda, sigma_color=fgs_sigma,
                                     confidence=conf)
        if min_confidence is not None:
            keep = self.last_confidence() >= min_confidence
            disp = torch.where(keep, disp, torch.zeros((), dtype=disp.dtype,
                                                       device=disp.device))
        return disp

    def last_confidence(self) -> torch.Tensor:
        """PKRN matching confidence [H, W] in [0, 1] of the last
        ``estimate``, from its aggregated volume, on its device."""
        from .ops.refine import confidence_pkrn
        if self._aggregation_volume is None:
            raise RuntimeError("run estimate() before last_confidence()")
        return confidence_pkrn(self._aggregation_volume)

    def estimate_fn(self) -> Callable:
        """The pipeline as a plain function ``(left, right) -> disparity``
        on tensors, with no capture of intermediates; SGM then takes
        winner-takes-all in its last launch where it can (the module's
        docstring)."""
        def fn(left_image, right_image):
            return self._run(left_image, right_image, fuse=True)[2]
        return fn

    def compiled(self, donate: bool = True) -> "CompiledPipeline":
        """The whole pipeline as one program a frame, the counterpart of
        the JAX package's ``compiled`` (a ``jax.jit`` of ``estimate_fn``):
        ``(left, right) -> disparity``, images numpy or tensors.

        On the card each input shape, dtype and device gets one CUDA
        graph of the frame, captured at its first call (after one eager
        run that builds and loads every kernel) and replayed from then
        on; see :class:`CompiledPipeline`.  A pipeline built for the CPU
        runs ``estimate_fn`` eagerly: the CPU has no graphs.

        ``donate`` is accepted for the JAX signature's sake and changes
        nothing: the graph's static input and volume buffers already make
        a replay allocate nothing but the copy of its disparity that it
        returns (a later call must not overwrite an earlier result)."""
        del donate
        return CompiledPipeline(self)


class _Graph(NamedTuple):
    """One captured frame: its static inputs and output, the launches of
    the hand-written kernels it holds (``_build.LAUNCHES`` keys), the
    device memory its private pool reserved, its nodes by type
    ("kernel", "memcpy", "memset", "other"), and the stamps among its
    kernel nodes (0 in a plain graph)."""
    graph: "torch.cuda.CUDAGraph"
    left: torch.Tensor
    right: torch.Tensor
    disparity: torch.Tensor
    launches: collections.Counter
    memory_bytes: int
    nodes: collections.Counter
    stamps: int

    @property
    def device_ops(self) -> int:
        """The device operations of a replay that are the program's own
        work: kernel, memcpy and memset nodes, stamps left out."""
        return (self.nodes["kernel"] + self.nodes["memcpy"]
                + self.nodes["memset"] - self.stamps)


# Device operations of a call around its replay: the two images copied
# into the static inputs, and the disparity copied out.
_CALL_COPIES = 3


class CompiledPipeline:
    """``Pipeline.compiled()``: a frame replayed as a CUDA graph.

    The first call for a (shape, dtype, device) key runs the frame once
    eagerly on a side stream (building the kernels and loading every
    module, which a capture cannot do), then captures it into a
    ``torch.cuda.CUDAGraph`` with static input tensors.  Every call
    validates the pair as ``estimate`` does, copies it into the static
    inputs, replays the graph and returns a clone of the static
    disparity.  A capture that fails raises ``RuntimeError`` naming the
    stage it failed in; nothing falls back to the eager frame.

    While a profiler records (``utils/profiling.py``), a call replays
    instead a second graph of the key, ``stamped[key]``, captured at the
    first such call: the same frame on the same static inputs, with a
    stamp before the cost stage and after each stage.  ``graphs[key]``
    never holds a stamp, so with no profiler recording the replay is the
    plain frame's.  The stamped graph keeps a memory pool of its own.

    A replay makes no host call, so ``_build.LAUNCHES`` does not count
    it: ``graphs[key].launches`` holds the kernel launches the capture
    recorded (one eager frame's).  Each graph keeps its volumes in its
    own memory pool (``graphs[key].memory_bytes``) for as long as this
    object lives.  ``device_ops`` counts the device operations the calls
    on the card enqueued for the frame: each replay's graph nodes, stamps
    left out, and the copies in and out.

    Replays of one graph share its static buffers, so calls from several
    threads or on several streams replay one at a time: a lock orders
    them on the host, and each waits on the device for the event
    recorded after the last one's copy out.
    """

    def __init__(self, pipeline: Pipeline):
        self.pipeline = pipeline
        self.graphs: Dict[Tuple, _Graph] = {}
        self.stamped: Dict[Tuple, _Graph] = {}
        self.device_ops = 0
        self._fn = pipeline.estimate_fn()
        self._lock = threading.Lock()
        self._done: Dict[Tuple, "torch.cuda.Event"] = {}

    def __call__(self, left_image: Image, right_image: Image,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The frame's disparity: a new tensor, or ``out`` (on the frame's
        device, the disparity's shape and dtype) with the disparity
        copied in on the current stream, which a later replay then
        cannot overwrite."""
        device = self.pipeline.device
        left_image = as_tensor(left_image, device)
        right_image = as_tensor(right_image, device)
        validation.check_stereo_pair(left_image, right_image)
        if not left_image.is_cuda:
            disparity = self._fn(left_image, right_image)
            return disparity if out is None else out.copy_(disparity)
        key = (tuple(left_image.shape), left_image.dtype, left_image.device)
        with self._lock:
            entry = self.graphs.get(key)
            if entry is None:
                entry = self.graphs[key] = self._capture(left_image,
                                                         right_image)
            replay = entry
            if profiling.recording():
                replay = self.stamped.get(key)
                if replay is None:
                    replay = self.stamped[key] = self._capture(
                        left_image, right_image, plain=entry)
            stream = torch.cuda.current_stream(left_image.device)
            if key in self._done:
                stream.wait_event(self._done[key])
            entry.left.copy_(left_image)
            entry.right.copy_(right_image)
            replay.graph.replay()
            if replay.stamps:
                profiling.stamp_ring(left_image.device).replayed(
                    replay.stamps)
            result = (replay.disparity.clone() if out is None
                      else out.copy_(replay.disparity))
            self._done[key] = torch.cuda.Event()
            self._done[key].record(stream)
            self.device_ops += entry.device_ops + _CALL_COPIES
        return result

    def _capture(self, left_image: torch.Tensor, right_image: torch.Tensor,
                 plain: Optional[_Graph] = None) -> _Graph:
        """The key's plain graph, or, given it as ``plain``, its stamped
        graph on the same static inputs."""
        device = left_image.device
        if plain is None:
            static_left = left_image.clone()
            static_right = right_image.clone()
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side), profiling.stamping(False):
                self._fn(static_left, static_right)
            torch.cuda.current_stream(device).wait_stream(side)
        else:
            static_left, static_right = plain.left, plain.right
            profiling.stamp_ring(device)      # a capture cannot make it
        torch.cuda.synchronize(device)
        # The capture empties the allocator's cache as it starts; empty it
        # first, so that what the capture reserves is the graph's pool.
        torch.cuda.empty_cache()
        # Kept after the capture, to count its nodes; instantiated below.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        counted = collections.Counter(_build.LAUNCHES)
        reserved = torch.cuda.memory_reserved(device)
        try:
            # "thread_local": a server's other threads may wait on events
            # or pin host memory while this thread captures.
            with profiling.stamping(plain is not None), torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                disparity = self._fn(static_left, static_right)
        except Exception as err:
            raise RuntimeError(
                f"capturing the frame as a CUDA graph failed in the "
                f"{self.pipeline._stage!r} stage: {err}") from err
        nodes = collections.Counter(profiling.graph_nodes(
            graph.raw_cuda_graph()))
        graph.instantiate()
        torch.cuda.synchronize(device)
        return _Graph(graph, static_left, static_right, disparity,
                      collections.Counter(_build.LAUNCHES) - counted,
                      torch.cuda.memory_reserved(device) - reserved, nodes,
                      0 if plain is None
                      else nodes["kernel"] - plain.nodes["kernel"])
