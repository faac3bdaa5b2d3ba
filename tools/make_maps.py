"""Write the reference-shaped example maps into data/.

Each map is generated from its seed by slam_tpu.maps.reference_like_map
and has the landmark/waypoint counts, loop length and .ini parameters of
one of the reference's example maps (BASELINE.md:21-27). The output is
deterministic; tests/test_maps.py checks the committed files against it.

Usage: python tools/make_maps.py [--out data]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

from slam_tpu.maps import REFERENCE_LIKE, write_reference_like  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), os.pardir, "data"))
    args = ap.parse_args()
    for name in REFERENCE_LIKE:
        for path in write_reference_like(name, args.out):
            print(path)


if __name__ == "__main__":
    main()
