#!/usr/bin/env python
"""Dataset fetcher: one command from an empty checkout to evaluable data.
The port's ``stm-fetch``, a copy of ``stereomatch_tpu/cli/fetch.py``
(the port imports nothing of the JAX package):

    python -m stereomatch_tpu_torch.cli.fetch teddy2003 --dest data

Counterpart of the reference's download recipe
(workflows/evaluation/Justfile:5-7), which wget+unzips the Middlebury 2021
scene archive.  Supported sets:

* ``middlebury2021`` — the 24-scene 2021 archive the reference's Flyte
  evaluation consumes (im0/im1.png, disp0/disp1.pfm, calib.txt per scene;
  ready for ``stm-eval``).
* ``teddy2003`` / ``cones2003`` — the Middlebury 2003 quarter-size
  PGM/PPM scenes the reference's unit tests fixture on
  (tests/conftest.py:15-31).

Uses only the stdlib (urllib + zipfile) so it works in the minimal
install.  ``--base-url`` accepts any mirror, including ``file://`` trees,
which is how the unit tests exercise the plumbing offline.
"""

import argparse
import sys
import zipfile
from pathlib import Path
from urllib.request import urlopen

MIDDLEBURY_2021 = "https://vision.middlebury.edu/stereo/data/scenes2021/zip"
MIDDLEBURY_2003 = ("https://vision.middlebury.edu/stereo/data/scenes2003/"
                   "newdata")

# 2003 scenes ship as loose files; these are the ones the pipelines read.
_2003_FILES = ("im2.ppm", "im6.ppm", "disp2.pgm", "disp6.pgm")

DATASETS = ("middlebury2021", "teddy2003", "cones2003")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset", choices=DATASETS,
                        help="Which dataset to fetch.")
    parser.add_argument("--dest", default="data/middlebury",
                        help="Destination directory (default: "
                             "data/middlebury).")
    parser.add_argument("--base-url", default=None,
                        help="Mirror override; file:// URLs work (tests use "
                             "them).  Default: vision.middlebury.edu.")
    return parser


def _download(url: str, dest: Path, chunk: int = 1 << 20) -> Path:
    dest.parent.mkdir(parents=True, exist_ok=True)
    tmp = dest.with_suffix(dest.suffix + ".part")
    print(f"fetching {url}", file=sys.stderr)
    with urlopen(url) as response, open(tmp, "wb") as out:
        while True:
            block = response.read(chunk)
            if not block:
                break
            out.write(block)
    tmp.rename(dest)
    return dest


def fetch_middlebury2021(dest: Path, base_url: str = None) -> Path:
    """Download + unpack the 2021 archive into ``dest`` (scene-per-folder,
    the layout MiddleburyDataset and stm-eval read)."""
    base = (base_url or MIDDLEBURY_2021).rstrip("/")
    archive = _download(f"{base}/all.zip", dest / "all.zip")
    with zipfile.ZipFile(archive) as zf:
        zf.extractall(dest)
    archive.unlink()
    return dest


def fetch_scene2003(scene: str, dest: Path, base_url: str = None) -> Path:
    """Download one Middlebury 2003 quarter-size scene (loose PGM/PPM)."""
    base = (base_url or MIDDLEBURY_2003).rstrip("/")
    scene_dir = dest / scene
    for name in _2003_FILES:
        _download(f"{base}/{scene}/{name}", scene_dir / name)
    return scene_dir


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dest = Path(args.dest)
    if args.dataset == "middlebury2021":
        out = fetch_middlebury2021(dest, args.base_url)
        print(f"Middlebury 2021 scenes ready under {out}\n"
              f"Evaluate with: python -m "
              f"stereomatch_tpu_torch.cli.evaluate {out}")
    else:
        scene = args.dataset.replace("2003", "")
        out = fetch_scene2003(scene, dest, args.base_url)
        print(f"{scene} (2003 quarter-size) ready under {out}\n"
              f"Run e.g.: python -m stereomatch_tpu_torch.cli.image "
              f"{out}/im2.ppm {out}/im6.ppm 64 disp.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
