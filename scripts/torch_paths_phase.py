"""chip_smoke.py's paths-mode phase (16) alone, on one CUDA GPU: the
kernels built from the checkout, then ``chip_smoke._paths_phase`` (a very
large project of two 375,000-frame SLEAP recordings through the main path
in paths mode, the modes against each other and card vs CPU on a prefix
copy).

    python3 scripts/torch_paths_phase.py [--out FILE] [--seeds S [S ...]]

Prints the card's name and power limit, then the phase's JSON line
(``"path": "paths"``); ``--out`` also writes the line to FILE. With
``--seeds`` the phase runs once for each fit seed, a line each (the soft
counts' comparisons over several trained bundles); the script fails if one
run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the phase's JSON lines here")
    parser.add_argument("--seeds", type=int, nargs="+", default=[None], help="the fit's seeds, a run each")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_paths_phase: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from deepof_tpu_torch.ops import cuda_build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"{card}; kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    lines, failed = [], []
    for seed in args.seeds:
        tmp = tempfile.mkdtemp(prefix="torch_paths_phase_")
        try:
            line, _ = chip_smoke._paths_phase(torch, card, tmp, seed=seed)
        except SystemExit:  # a failed check; its message is on stderr
            failed.append(seed)
            continue
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        lines.append(json.dumps(line))
        print(lines[-1], flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                f.write("\n".join(lines) + "\n")
    if failed:
        print(f"torch_paths_phase: the run failed for seeds {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
