#!/usr/bin/env python
"""CLI for estimating disparity from a stereo image pair.

The port's ``stm-image`` (the reference's ``stereomatch/cli_image.py:34-100``),
with the flags of ``stereomatch_tpu/cli/image.py``:

    python -m stereomatch_tpu_torch.cli.image left.png right.png 64 out.png \
        -cm census -am sgm --refine

It runs on the card (``--device cuda``, the default) or on the CPU
(``--device cpu``).  ``--backend`` takes the port's names: ``cuda``
demands the hand-written kernels, ``torch`` runs the plain versions,
``auto`` takes a kernel where it serves the shape (the JAX package's
``pallas``, ``xla`` and ``auto``).  PNG is read and written with the
port's own codec and PGM/PPM read with its own reader (``io/png.py``,
``io/data.py``), so neither PIL nor matplotlib is needed for them; other
formats go through PIL (``-sd`` imports matplotlib).  ``--pyramid
LEVELS`` runs ``pyramid.PyramidPipeline`` (census + SGM at 1/2**LEVELS,
then band refinement; ``--refine`` takes its in-band sub-pixel step,
``--dtype`` its coarse volume's dtype).
"""

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    from ..cli_common import (AGGREGATION_METHODS, COST_METHODS,
                              DISPARITY_METHODS)
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("left_image", metavar="left-image", help="Left image")
    parser.add_argument("right_image", metavar="right-image",
                        help="Right image")
    parser.add_argument("max_disparity", metavar="max-disparity", type=int,
                        help="Maximum disparity for stereo matching.")
    parser.add_argument("output_depthmap", metavar="output-depthmap",
                        help="Output PNG file for the depth map.")
    parser.add_argument("-cm", "--cost-method", choices=COST_METHODS.keys(),
                        default="ssd", help="Cost function.")
    parser.add_argument("-am", "--aggregation-method",
                        choices=AGGREGATION_METHODS.keys(), default=None,
                        help="Aggregation method.")
    parser.add_argument("-dm", "--disparity-method",
                        choices=DISPARITY_METHODS.keys(), default="wta",
                        help="Disparity reduce method.")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where the pipeline runs: the card (default) "
                             "or the CPU.")
    parser.add_argument("-sd", "--show-depthmap", action="store_true",
                        help="Show the depthmap interactively.")
    parser.add_argument("-fig", "--figure", action="store_true",
                        help="Render inputs alongside the depthmap.")
    parser.add_argument("--p1", type=float, default=0.1,
                        help="SGM penalty for +-1 disparity changes.")
    parser.add_argument("--p2", type=float, default=0.2,
                        help="SGM base penalty for larger jumps "
                             "(adaptively scaled by image gradient).")
    parser.add_argument("--cvf-radius", type=int, default=8,
                        help="-am cvf: box window half-size (use smaller "
                             "radii on small images).")
    parser.add_argument("--cvf-eps", type=float, default=1e-4,
                        help="-am cvf: edge-stop regularizer in "
                             "intensity^2 units; larger smooths across "
                             "weaker image edges.")
    parser.add_argument("--cvf-subsample", type=int, default=1,
                        help="-am cvf: > 1 = Fast Guided Filter "
                             "(statistics on an s x-downsampled grid; "
                             "faster, approximate).")
    parser.add_argument("--census-window", type=int, default=5,
                        help="-cm census: code window (odd; >5 packs "
                             "several int32 words, e.g. 7 or 9 for the "
                             "larger production census windows).")
    parser.add_argument("--backend", choices=("auto", "cuda", "torch"),
                        default="auto",
                        help="Kernels or plain versions for the stages "
                             "that have both: 'cuda' the hand-written "
                             "kernels, 'torch' the plain PyTorch versions, "
                             "'auto' a kernel where it serves the shape.")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32",
                        help="Cost-volume storage dtype (bfloat16 halves "
                             "the volume's bytes; recurrences stay "
                             "float32).")
    parser.add_argument("--pyramid", type=int, default=0, metavar="LEVELS",
                        help="Coarse-to-fine mode: run census+SGM at "
                             "1/2**LEVELS resolution and disparity range, "
                             "then refine a narrow per-pixel band up to "
                             "full resolution (overrides -cm/-am/-dm).")
    parser.add_argument("--band-radius", type=int, default=24, metavar="R",
                        help="Half-width of the per-pixel refinement band "
                             "in --pyramid mode.")
    parser.add_argument("--refine", action="store_true",
                        help="Post-process: 3x3 median + parabolic "
                             "sub-pixel interpolation.")
    parser.add_argument("--lr-check", action="store_true",
                        help="Left-right consistency check with background "
                             "occlusion fill.")
    parser.add_argument("--lr-mode", choices=("mirror", "volume"),
                        default="mirror",
                        help="Right disparity for --lr-check: 'mirror' "
                             "re-runs the pipeline on mirrored images "
                             "(exact, 2x cost); 'volume' re-indexes the "
                             "left aggregated volume (approximate under "
                             "aggregation).")
    parser.add_argument("--wmf", action="store_true",
                        help="Guide-weighted median filter (runs before "
                             "--refine's median/sub-pixel).")
    parser.add_argument("--wmf-sigma", type=float, default=10.0,
                        help="Affinity bandwidth in guide gray levels "
                             "(8-bit scale).")
    parser.add_argument("--fgs", type=float, default=None, metavar="LAM",
                        help="Fast-global-smoother post-filter with total "
                             "smoothness weight LAM; with --lr-check the "
                             "consistency mask weights the data term.")
    parser.add_argument("--fgs-sigma", type=float, default=8.0,
                        help="FGS edge-stop bandwidth in guide gray "
                             "levels (8-bit scale).")
    parser.add_argument("--speckle", action="store_true",
                        help="Suppress speckles (small isolated disparity "
                             "blobs) of the final map.")
    parser.add_argument("--speckle-fill", choices=("zero", "background"),
                        default="zero",
                        help="Replacement for speckle pixels: 0 (unknown) "
                             "or the nearest background disparity along "
                             "the scanline.")
    parser.add_argument("--min-confidence", type=float, default=None,
                        metavar="T",
                        help="Mark pixels with PKRN confidence below T as "
                             "unknown (disparity 0).")
    parser.add_argument("--confidence", metavar="PATH", default=None,
                        help="Also write the PKRN matching-confidence map "
                             "(grayscale PNG; white = unambiguous match).")
    parser.add_argument("--calib", metavar="PATH", default=None,
                        help="Middlebury calib.txt (cam0/baseline/doffs) "
                             "enabling metric output (--depth, "
                             "--point-cloud).")
    parser.add_argument("--depth", metavar="PATH", default=None,
                        help="Also write metric depth as a PFM file "
                             "(requires --calib).")
    parser.add_argument("--point-cloud", metavar="PATH", default=None,
                        help="Also write a colored 3-D point cloud as "
                             "binary PLY (requires --calib).")
    parser.add_argument("--max-depth", type=float, default=None,
                        help="Far-plane cut for --point-cloud.")
    return parser


def _refusal(args):
    """The message of a refused combination of options, or None."""
    if args.pyramid > 0:
        # --refine is served: the final band stage takes the sub-pixel
        # vertex from the winner's neighbour costs.
        incompatible = [flag for flag, on in [
            ("--lr-check", args.lr_check),
            ("--wmf", args.wmf),
            ("--fgs", args.fgs is not None),
            ("--min-confidence", args.min_confidence is not None),
            ("--confidence", args.confidence is not None)] if on]
        if incompatible:
            return (f"--pyramid is incompatible with {' '.join(incompatible)} "
                    "(the band stage has no full cost volume to "
                    "post-process).")
    for path in (args.output_depthmap, args.confidence):
        if path is not None and not path.lower().endswith(".png"):
            try:
                import PIL  # noqa: F401
            except ImportError:
                return (f"{path}: writing other formats than PNG needs "
                        f"PIL, which is not installed.")
    return None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    refusal = _refusal(args)
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    if (args.depth or args.point_cloud) and not args.calib:
        print("--depth/--point-cloud require --calib.", file=sys.stderr)
        return 2

    import numpy as np

    from ..cli_common import create_pipeline
    from ..io.data import load_image, save_image
    from ..pipeline import host_array

    if args.pyramid > 0:
        from ..pyramid import PyramidPipeline
        pipeline = PyramidPipeline(
            args.max_disparity, levels=args.pyramid,
            band_radius=args.band_radius, penalty1=args.p1,
            penalty2=args.p2, backend=args.backend, cost_dtype=args.dtype,
            device=args.device)
    else:
        pipeline = create_pipeline(args.cost_method, args.disparity_method,
                                   args.aggregation_method,
                                   max_disparity=args.max_disparity,
                                   penalty1=args.p1, penalty2=args.p2,
                                   cvf_radius=args.cvf_radius,
                                   cvf_eps=args.cvf_eps,
                                   cvf_subsample=args.cvf_subsample,
                                   census_window=args.census_window,
                                   backend=args.backend,
                                   volume_dtype=args.dtype,
                                   device=args.device)

    left = load_image(args.left_image, "L").astype(np.float32)
    right = load_image(args.right_image, "L").astype(np.float32)

    if args.pyramid > 0 and args.refine:
        disparity = pipeline.estimate_refined(left, right)
    elif (args.refine or args.lr_check or args.wmf or args.fgs is not None
            or args.min_confidence is not None):
        disparity = pipeline.estimate_refined(
            left, right, subpixel=args.refine, median=args.refine,
            lr_check=args.lr_check, lr_mode=args.lr_mode,
            weighted_median=args.wmf, wmf_sigma=args.wmf_sigma,
            fgs_lambda=args.fgs, fgs_sigma=args.fgs_sigma,
            min_confidence=args.min_confidence)
    else:
        disparity = pipeline.estimate(left, right)
    if args.speckle:
        from ..ops.refine import filter_speckles
        disparity = filter_speckles(disparity, fill=args.speckle_fill)
    disparity = host_array(disparity)
    inputs = None
    if args.figure:
        inputs = (load_image(args.left_image, "RGB"),
                  load_image(args.right_image, "RGB"))
    canvas = render_panels(disparity, inputs=inputs)
    save_image(args.output_depthmap, canvas)

    if args.confidence:
        conf = host_array(pipeline.last_confidence())
        save_image(args.confidence, (conf * 255).astype(np.uint8))

    if args.depth or args.point_cloud:
        from ..reconstruction import (CameraIntrinsics, depth_from_disparity,
                                      reproject_disparity, write_ply)
        intr = CameraIntrinsics.from_middlebury_calib(args.calib)
        if args.depth:
            from ..io.data import write_pfm
            write_pfm(args.depth,
                      host_array(depth_from_disparity(disparity, intr)))
        if args.point_cloud:
            points = reproject_disparity(disparity, intr)
            n = write_ply(args.point_cloud, points,
                          colors=load_image(args.left_image, "RGB"),
                          max_depth=args.max_depth)
            print(f"{args.point_cloud}: {n} points", file=sys.stderr)

    if args.show_depthmap:
        import matplotlib.pyplot as plt
        plt.imshow(canvas)
        plt.axis("off")
        plt.show()
    return 0


def render_panels(disparity, inputs=None, pad: int = 8):
    """Render the disparity map, optionally beside the input pair, as one
    uint8 RGB canvas (pixel-exact, no plotting-library margins).

    The disparity map is colormapped over its own range; ``inputs`` is a
    pair of uint8 [H, W, 3] RGB images, and the three panels are then
    letterboxed to a common height and separated by white gutters.
    """
    import numpy as np
    from ..utils.viz import colorize_disparity

    panels = [colorize_disparity(disparity)]
    if inputs is not None:
        panels = [np.ascontiguousarray(im) for im in inputs] + panels

    height = max(p.shape[0] for p in panels)
    boxed = []
    for p in panels:
        top = (height - p.shape[0]) // 2
        boxed.append(np.pad(p, ((top, height - p.shape[0] - top),
                                (0, 0), (0, 0)),
                            constant_values=255))
    gutter = np.full((height, pad, 3), 255, np.uint8)
    strip = [boxed[0]]
    for p in boxed[1:]:
        strip += [gutter, p]
    return np.concatenate(strip, axis=1)


if __name__ == "__main__":
    sys.exit(main())
