#!/usr/bin/env python
"""Evaluation harness: run pipeline configs over a Middlebury-format dataset
(or generated scenes) and report RMSE / average error / bad-pixel metrics
as a markdown table.

The port's ``stm-eval``, with the flags and config grammar of
``stereomatch_tpu/cli/evaluate.py``:

    python -m stereomatch_tpu_torch.cli.evaluate --synthetic 2 \
        --configs ssd:wta:sgm+refine,ssd:dyn:sgm

Pipelines run on the card (``--device cuda``, the default) or on the CPU
(``--device cpu``).  Per scene, ``max_disparity`` is next_power_of_2
(ndisp), as the reference's predict task sets it.  ``--tune N`` fits each
SGM config's penalties first (``tune.py``, on N generated scenes, seeds
200 + i); ``pyramidN`` configs run ``pyramid.PyramidPipeline``.
"""

import argparse
import json
import sys

DEFAULT_CONFIGS = [
    ("ssd", "wta", None, frozenset()),
    ("ssd", "dyn", None, frozenset()),
    ("ssd", "dyn", "sgm", frozenset()),
]


def build_parser() -> argparse.ArgumentParser:
    from ..cli_common import add_census_sgm_options
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset_dir", nargs="?", default=None,
                        help="Middlebury-format dataset dir (omit with "
                             "--synthetic)")
    parser.add_argument("--synthetic", type=int, default=None, metavar="N",
                        help="Evaluate on N generated occlusion-aware "
                             "synthetic scenes instead of a dataset — the "
                             "zero-network evaluation path (occluded pixels "
                             "are masked out of the metrics via the gt=0 "
                             "unknown convention, like Middlebury PFMs).")
    parser.add_argument("--synthetic-size", default="96x128x32",
                        metavar="HxWxD",
                        help="Geometry of --synthetic scenes.")
    parser.add_argument("--synthetic-texture", default="noise",
                        choices=("noise", "textured"),
                        help="Surface model for --synthetic scenes: "
                             "'noise' (smoothed random; the guide image "
                             "carries no edge structure) or 'textured' "
                             "(per-surface base intensities + smooth "
                             "interiors — the regime guide-aware stages "
                             "like cvf/wmf are built for).")
    parser.add_argument("--format", choices=("middlebury", "kitti"),
                        default="middlebury",
                        help="Dataset layout: folder-per-scene Middlebury "
                             "(im0/im1.png, disp0.pfm, calib.txt) or "
                             "KITTI 2015 (image_2/, image_3/, disp_occ_0/ "
                             "uint16 PNGs).")
    parser.add_argument("--max-disparity", type=int, default=None,
                        help="Override every scene's disparity range "
                             "(Middlebury reads per-scene ndisp; KITTI "
                             "has no per-scene value and defaults to "
                             "the benchmark's 192).")
    parser.add_argument("--max-size", type=int, default=None,
                        help="Evaluate at most this many scenes.")
    parser.add_argument("--configs", default=None,
                        help="Comma-separated cost:disp[:aggr][+refine] "
                             "configs, e.g. 'ssd:wta,census:wta:sgm+refine' "
                             "(+refine = median + sub-pixel). Default: the "
                             "reference's three configs.")
    parser.add_argument("--bad-threshold", type=float, default=2.0)
    parser.add_argument("--cvf-radius", type=int, default=8,
                        help="cvf configs: box window half-size (shrink "
                             "on small scenes).")
    parser.add_argument("--cvf-eps", type=float, default=1e-4,
                        help="cvf configs: edge-stop regularizer.")
    parser.add_argument("--confidence", action="store_true",
                        help="Also score each config's PKRN confidence map "
                             "via sparsification AUSE (0 = ranks pixels as "
                             "well as knowing the true error; scale = the "
                             "config's own bad-pixel ratio).")
    parser.add_argument("--json", dest="json_out", default=None,
                        help="Also write raw metric rows to this JSON file.")
    parser.add_argument("--cache", default=None, metavar="DIR",
                        help="Cache predicted disparities in DIR and reuse "
                             "them on re-runs (the reference's Flyte tasks "
                             "set cache=True, workflow.py:41).")
    parser.add_argument("--tune", type=int, default=None, metavar="N",
                        help="Before evaluating, fit each SGM config's "
                             "P1/P2 by gradient descent (tune.py) on N "
                             "generated scenes disjoint from the "
                             "evaluation set. Requires --synthetic "
                             "(tuning needs ground truth at one common "
                             "geometry).")
    parser.add_argument("--tune-steps", type=int, default=60,
                        help="Adam steps for --tune.")
    parser.add_argument("--tune-tau", type=float, default=2.0,
                        help="Soft-argmin temperature for --tune, in cost "
                             "units (census Hamming counts, SSD sums, "
                             "...).")
    parser.add_argument("--wmf-sigma", type=float, default=None,
                        help="+wmf affinity bandwidth in guide intensity "
                             "units. Default: 10 (gray levels) for real "
                             "8-bit datasets, 0.1 for --synthetic scenes "
                             "([0, 1] intensity — sigma 10 there would "
                             "degenerate the filter to a plain median).")
    parser.add_argument("--fgs-lambda", type=float, default=16.0,
                        help="+fgs configs: smoothing strength of the "
                             "confidence-weighted fast global smoother.")
    parser.add_argument("--fgs-sigma", type=float, default=None,
                        help="+fgs affinity bandwidth in guide intensity "
                             "units. Default: 8 (gray levels) for real "
                             "8-bit datasets, 0.08 for --synthetic "
                             "scenes.")
    parser.add_argument("--census-window", type=int, default=5,
                        help="census configs: code window (odd; >5 packs "
                             "several int32 words).")
    add_census_sgm_options(parser)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="Where the pipelines run: the card (default) "
                             "or the CPU.")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32",
                        help="Cost-volume storage dtype; run the table "
                             "twice to quantify bfloat16's accuracy cost "
                             "on real data.")
    return parser


def parse_configs(spec):
    """``cost:disp[:aggr][+refine][+speckle]`` or ``pyramidN[+...]``.

    ``+refine`` routes the config through ``estimate_refined`` (3x3
    median + parabolic sub-pixel) — the float output mainly moves RMSE /
    avg-err, which the integer-step bad-pixel metric barely sees.
    ``+speckle`` applies windowed-support speckle suppression
    (background fill, so no pixels leave the metrics' valid mask).
    ``+wmf`` applies the guide-weighted median (edge-preserving; the
    affinity bandwidth follows --wmf-sigma, whose default adapts to the
    dataset's intensity scale) before the refine stages.
    ``+fgs`` applies the confidence-weighted fast global smoother
    (--fgs-lambda / --fgs-sigma; sigma's default adapts like wmf's).
    """
    configs = []
    for item in spec.split(","):
        head, *mods = item.strip().split("+")
        bad = set(mods) - {"refine", "speckle", "wmf", "fgs"}
        if bad:
            raise ValueError(f"Unknown config modifiers: {sorted(bad)}")
        mods = frozenset(mods)
        parts = head.split(":")
        if parts[0].startswith("pyramid"):
            # coarse-to-fine mode: "pyramid", "pyramid1", "pyramid2", ...
            # It names a whole pipeline, so trailing :parts are a
            # malformed spec, not a cost method — fail here, not with a
            # KeyError deep inside the run.
            if len(parts) != 1:
                raise ValueError(
                    f"Bad config spec: {item!r} (pyramidN takes no "
                    f":cost/:disp parts)")
            int(parts[0][len("pyramid"):] or "1")   # validate early
            if mods & {"wmf", "fgs"}:
                # Would silently no-op but still label the row "-wmf".
                raise ValueError(
                    "pyramidN does not support +wmf/+fgs (the band stage "
                    "has no full cost volume / bin range)")
            configs.append((parts[0], None, None, mods))
        elif len(parts) == 2:
            configs.append((parts[0], parts[1], None, mods))
        elif len(parts) == 3:
            configs.append((parts[0], parts[1], parts[2], mods))
        else:
            raise ValueError(f"Bad config spec: {item!r}")
    return configs


def grayscale(image):
    import numpy as np
    if image.ndim == 2:
        return image.astype(np.float32)
    # RGB luma, matching torchvision's rgb_to_grayscale used by the
    # reference's predict task (workflow.py:28).
    weights = np.array([0.299, 0.587, 0.114], np.float32)
    return (image[..., :3].astype(np.float32) @ weights)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.tune and not args.synthetic:
        print("--tune requires --synthetic (it fits penalties on "
              "generated ground-truth scenes).", file=sys.stderr)
        return 2

    import numpy as np
    import torch

    from ..cli_common import census_sgm_refusal, create_pipeline, start_device
    from ..io.data import MiddleburyDataset
    from ..metrics import evaluate, metrics_markdown_table
    from ..pipeline import host_array
    from ..utils.numeric import next_power_of_2

    start_device(args.device)

    configs = (parse_configs(args.configs) if args.configs
               else DEFAULT_CONFIGS)
    # The tuner and the pyramid run a square census and the adaptive P2.
    refusal = census_sgm_refusal(args, "--tune") if args.tune else None
    if refusal is None and any(c[1] is None for c in configs):
        refusal = census_sgm_refusal(args, "a pyramidN config")
    if refusal:
        print(refusal, file=sys.stderr)
        return 2
    if args.synthetic:
        from ..io.synthetic import stereo_pair_occluded
        h, w, d = (int(v) for v in args.synthetic_size.split("x"))
        items = []
        for i in range(args.synthetic):
            left, right, gt, occ = stereo_pair_occluded(
                h, w, d, seed=100 + i, texture=args.synthetic_texture)
            items.append({
                "stereo_name": f"synthetic{i:02d}",
                "left": left, "right": right,
                # gt == 0 marks unknown pixels for the metrics (the
                # Middlebury convention): occluded pixels have no right
                # correspondence, so they are excluded like real
                # datasets' unknown regions.
                "gt_disparity": np.where(occ, 0, gt).astype(np.float32),
                "max_disparity": d,
            })
    else:
        if not args.dataset_dir:
            print("dataset_dir or --synthetic required.", file=sys.stderr)
            return 2
        if args.format == "kitti":
            from ..io.data import KittiDataset
            dataset = KittiDataset(args.dataset_dir, max_size=args.max_size,
                                   **({"max_disparity": args.max_disparity}
                                      if args.max_disparity else {}))
        else:
            dataset = MiddleburyDataset(args.dataset_dir,
                                        max_size=args.max_size)
        items = [dataset[i] for i in range(len(dataset))]
        if args.max_disparity:
            for item in items:
                item["max_disparity"] = args.max_disparity
    if not items:
        print("No scenes found.", file=sys.stderr)
        return 1

    tuned_cache = {}

    def tuned_penalties(cost_m):
        """Fit P1/P2 for this cost family on scenes disjoint from the
        evaluation seeds (evaluation uses 100 + i; tuning 200 + i)."""
        if cost_m in tuned_cache:
            return tuned_cache[cost_m]
        from ..io.synthetic import stereo_pair_occluded
        from .. import tune as tune_mod
        h, w, d = (int(v) for v in args.synthetic_size.split("x"))
        d_pow2 = next_power_of_2(d)
        scenes, masks = [], []
        for i in range(args.tune):
            left, right, gt, occ = stereo_pair_occluded(h, w, d,
                                                        seed=200 + i)
            scenes.append((grayscale(left), grayscale(right), gt))
            mask = np.zeros(gt.shape, bool)
            mask[:, d_pow2:] = True
            mask &= ~occ            # occluded pixels have no true match
            masks.append(mask)
        res = tune_mod.tune_penalties(
            scenes, max_disparity=d_pow2, cost=cost_m,
            steps=args.tune_steps, tau=args.tune_tau,
            valid_masks=np.stack(masks), device=args.device)
        tuned_cache[cost_m] = (res.penalty1, res.penalty2)
        return tuned_cache[cost_m]

    # [0, 1]-intensity synthetic scenes need a [0, 1]-scale affinity
    # bandwidth; real datasets are 8-bit-range grayscale.
    wmf_sigma = (args.wmf_sigma if args.wmf_sigma is not None
                 else (0.1 if args.synthetic else 10.0))
    fgs_sigma = (args.fgs_sigma if args.fgs_sigma is not None
                 else (0.08 if args.synthetic else 8.0))
    rows = []
    for cost_m, disp_m, aggr_m, mods in configs:
        refined = "refine" in mods
        name = "-".join(filter(None, [cost_m, disp_m, aggr_m]))
        is_pyramid = cost_m.startswith("pyramid") and disp_m is None
        if is_pyramid:
            if args.confidence:
                print("--confidence is unavailable for pyramid configs "
                      "(the band stage has no full cost volume).",
                      file=sys.stderr)
                return 2
            levels = int(cost_m[len("pyramid"):] or "1")
            pipeline = None         # built per scene (range is baked in)
        penalty_kwargs = {}
        if args.tune and aggr_m == "sgm":
            p1, p2 = tuned_penalties(cost_m)
            penalty_kwargs = {"penalty1": p1, "penalty2": p2}
            name += "-tuned"
        # Only the costs with a storage dtype take the flag; labeling
        # other configs with it would attribute f32 numbers to bf16.
        dtyped_costs = ("ssd", "census", "sad", "ncc")
        if args.dtype != "float32" and cost_m in dtyped_costs:
            name += f"-{args.dtype}"
        if "wmf" in mods:
            name += "-wmf"
        if "fgs" in mods:
            name += "-fgs"
        if refined:
            name += "-refine"
        if "speckle" in mods:
            name += "-speckle"
        if not is_pyramid:
            pipeline = create_pipeline(cost_m, disp_m, aggr_m,
                                       volume_dtype=(args.dtype
                                                     if cost_m in dtyped_costs
                                                     else "float32"),
                                       cvf_radius=args.cvf_radius,
                                       cvf_eps=args.cvf_eps,
                                       census_window=args.census_window,
                                       census_height=args.census_height,
                                       adaptive_p2=not args.constant_p2,
                                       device=args.device, **penalty_kwargs)
        per_scene = []
        for item in items:
            left = grayscale(item["left"])
            right = grayscale(item["right"])
            # Reference mutates max_disparity per scene (workflow.py:34).
            d_scene = next_power_of_2(item["max_disparity"])
            if is_pyramid:
                if pipeline is None or pipeline.max_disparity != d_scene:
                    from ..pyramid import PyramidPipeline
                    pipeline = PyramidPipeline(d_scene, levels=levels,
                                               device=args.device)
            else:
                pipeline.cost.max_disparity = d_scene
            cache_file = None
            if args.cache:
                from pathlib import Path
                cache_dir = Path(args.cache)
                cache_dir.mkdir(parents=True, exist_ok=True)
                cache_file = cache_dir / (
                    f"{name}_{item['stereo_name']}_"
                    f"{left.shape[0]}x{left.shape[1]}_"
                    f"d{d_scene}.npy")
            conf_file = (cache_file.with_name(cache_file.stem + "_conf.npy")
                         if cache_file is not None else None)
            cached = (cache_file is not None and cache_file.exists()
                      and (not args.confidence or conf_file.exists()))
            if cached:
                predicted = np.load(cache_file)
                conf = np.load(conf_file) if args.confidence else None
            else:
                use_wmf = "wmf" in mods      # pyramid+wmf rejected at parse
                use_fgs = "fgs" in mods
                if use_wmf or use_fgs:
                    predicted = pipeline.estimate_refined(
                        left, right, subpixel=refined, median=refined,
                        weighted_median=use_wmf, wmf_sigma=wmf_sigma,
                        fgs_lambda=(args.fgs_lambda if use_fgs else None),
                        fgs_sigma=fgs_sigma)
                elif refined:
                    predicted = pipeline.estimate_refined(left, right)
                else:
                    predicted = pipeline.estimate(left, right)
                if "speckle" in mods:
                    from ..ops.refine import filter_speckles
                    predicted = filter_speckles(
                        predicted.to(torch.float32), fill="background")
                predicted = host_array(predicted)
                conf = (host_array(pipeline.last_confidence())
                        if args.confidence else None)
                if cache_file is not None:
                    np.save(cache_file, predicted)
                    if conf is not None:
                        np.save(conf_file, conf)
            scene_metrics = evaluate(predicted, item["gt_disparity"],
                                     threshold=args.bad_threshold)
            if conf is not None:
                from ..metrics import sparsification_ause
                scene_metrics["ause"] = sparsification_ause(
                    predicted, item["gt_disparity"], conf,
                    threshold=args.bad_threshold)
            scene_metrics["scene"] = item["stereo_name"]
            per_scene.append(scene_metrics)
        row = {
            "name": name,
            "rmse": float(np.mean([m["rmse"] for m in per_scene])),
            "avg_abs_error": float(np.mean([m["avg_abs_error"]
                                            for m in per_scene])),
            "bad_pixel_ratio": float(np.mean([m["bad_pixel_ratio"]
                                              for m in per_scene])),
            "scenes": per_scene,
        }
        if args.confidence:
            row["ause"] = float(np.mean([m["ause"] for m in per_scene]))
        if penalty_kwargs:
            row.update(penalty_kwargs)
        rows.append(row)

    print(metrics_markdown_table(rows))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(rows, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
