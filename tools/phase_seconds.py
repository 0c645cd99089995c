#!/usr/bin/env python3
"""Seconds of each ``chip_smoke.py`` phase, read from the standard output
of one or more runs, side by side.

    python3 tools/phase_seconds.py RUN.txt [RUN2.txt ...] [--labels A B ...]

Every phase line of ``chip_smoke.py`` carries ``elapsed_s``, the seconds
since the script started.  A phase's seconds are the ``elapsed_s`` of its
last line minus that of the last line before it of another phase, summed
over the phase's stretches (the ``kernel`` phase, say, prints between the
timing phases); the ``env`` line opens the first stretch.  Prints one row
a phase, in the first run's order, then each run's total (the last phase
line's ``elapsed_s``) and the card line (``nvidia-smi``'s name and power
limit) the run printed.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Tuple


def phases(path: str) -> Tuple[Dict[str, float], float, str]:
    """(seconds by phase in first-seen order, total, the card line)."""
    seconds: Dict[str, float] = {}
    last_phase, last_t, card = None, 0.0, ""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                if ", " in line and line.endswith(" W"):
                    card = line
                continue
            try:
                obj = json.loads(line)
            except json.JSONDecodeError:
                continue
            phase, t = obj.get("phase"), obj.get("elapsed_s")
            if phase is None or t is None:
                continue
            if phase == "env":
                card = card or obj.get("nvidia_smi", "")
            if last_phase is not None:
                seconds[phase] = seconds.get(phase, 0.0) + t - last_t
            else:
                seconds.setdefault(phase, 0.0)
            last_phase, last_t = phase, t
    return seconds, last_t, card


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("runs", nargs="+")
    parser.add_argument("--labels", nargs="*", default=None)
    args = parser.parse_args()
    labels: List[str] = args.labels or args.runs
    read = [phases(p) for p in args.runs]
    order: List[str] = []
    for secs, _, _ in read:
        order += [p for p in secs if p not in order]
    width = max(len(p) for p in order + ["total"])
    print(" ".join(["phase".ljust(width)] + [f"{l:>12}" for l in labels]))
    for p in order:
        cells = [f"{secs[p]:12.1f}" if p in secs else f"{'-':>12}"
                 for secs, _, _ in read]
        print(" ".join([p.ljust(width)] + cells))
    print(" ".join(["total".ljust(width)]
                   + [f"{total:12.1f}" for _, total, _ in read]))
    for label, (_, _, card) in zip(labels, read):
        print(f"{label}: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
