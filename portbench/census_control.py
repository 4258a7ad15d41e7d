"""Readings that the correctness limits of a census + SGM cell are set
from, on the card: ``portbench/control.py`` with the faults of
``portbench/census_faults.py``.

    python portbench/census_control.py \
        --workload kitti-census-sgm.stream8 --seeds 11,12 --seconds 3 \
        --faults window_9x9,window_7x7,p2_adaptive,path_left_out,p1_ignored

The arguments, the windows and the output are ``control.py``'s; a fault
name is looked up in ``census_faults.planted``, which falls back on
``faults.planted``.  The benchmark's own runs never run this.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    sys.path.insert(0, str(ROOT))
    from portbench import census_faults, control, faults
    # control.main plants each fault through faults.planted.
    faults.planted = census_faults.planted
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
