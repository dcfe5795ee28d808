"""One ``chip_smoke.py`` phase of two checkouts, in turns on one card.

Usage (from the root of a checkout, on a machine with a CUDA card and nvcc):

    git archive <older commit> | tar -x -C build/parent
    python3 scripts/torch_phase_ab.py --parent build/parent [--phase detection] [--seed 0]

Runs ``phase_<name>(torch, seed, smi)`` of the ``--parent`` tree's ``chip_smoke.py``
and of this checkout's in the order parent, change, change, parent, each in a process
of its own (the two trees' packages share names) after that tree's ``phase_build``.
Every JSON line a run prints is printed again with ``"tree"`` and ``"turn"`` added, so
the walls of the two versions stand side by side from one card and one host. The last
line is the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import sys

import torch

sys.path.insert(0, ".")
import chip_smoke

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
smi = chip_smoke.phase_device(torch)
chip_smoke.phase_build()
getattr(chip_smoke, "phase_" + sys.argv[1])(torch, int(sys.argv[2]), smi)
"""


def run_phase(root: str, phase: str, seed: int, timeout: int) -> list:
    """The JSON lines of one run of ``phase`` in the tree at ``root``."""
    proc = subprocess.run([sys.executable, "-c", CHILD, phase, str(seed)], cwd=root, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"phase {phase} in {root} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True, help="root of a checkout of the version to compare against")
    parser.add_argument("--phase", default="detection", help="a chip_smoke phase taking (torch, seed, smi)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--timeout", type=int, default=900, help="seconds for each run")
    args = parser.parse_args()

    trees = {"parent": os.path.abspath(args.parent), "change": REPO}
    for turn, tag in enumerate(("parent", "change", "change", "parent")):
        for line in run_phase(trees[tag], args.phase, args.seed, args.timeout):
            print(json.dumps({"tree": tag, "turn": turn, **line}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
