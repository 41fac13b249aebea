"""A/B of the port between two trees on one CUDA GPU: the serving path's
seconds from chip_smoke.py, and the RecurrentBlock's time at several latents.

    python3 scripts/torch_ab_path.py --blocks ROOT [--latents 4 8 16 64]
    python3 scripts/torch_ab_path.py --summarize A.jsonl B.jsonl

``--blocks`` imports deepof_tpu_torch from ROOT (a checkout of any commit of
the port; its kernels build into ROOT/build/cuda) and times, through that
tree's own modules, the serving encoder's node block (4096 x 28 streams, 3
features) and edge block (4096 x 32 streams, 1 feature) at each latent:
``RecurrentBlock.forward``, and its first BiGRU alone (``gru1(x, mask)``),
with every window full; CUDA events over 10 calls after 2 warm ones. Prints
the card's name and power limit, then one JSON line.

``--summarize`` reads files of JSON lines, one file per tree, each line
either chip_smoke.py's stage line (the one with "total_s") or a --blocks
line, written in turns (A, B, B, A, ...). Prints per file the median and
quartiles of the path's seconds, embed seconds and frames/s and the median
block times, and with two files how many of the paired path runs (the k-th
of one file against the k-th of the other) each tree won. A call on the
card, with the other tree unpacked into the git-ignored build/parent:

    for root in build/parent . . build/parent; do
      (cd $root && python3 chip_smoke.py) | grep '"total_s"' >> chiprun_out/ab_$(basename $root).jsonl
    done
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

WINDOW = 25
BLOCKS = {"node": (4096 * 28, 3), "edge": (4096 * 32, 1)}


def _ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def blocks(root: str, latents) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from deepof_tpu_torch.models.blocks import RecurrentBlock

    g = torch.Generator().manual_seed(2)
    out = {}
    for latent in latents:
        d = min(64, latent)
        for name, (b, f) in BLOCKS.items():
            block = RecurrentBlock(f, latent, torch.Generator().manual_seed(0)).to("cuda").eval()
            x = torch.randn(b, WINDOW, f, generator=g).to("cuda")
            y = torch.randn(b, WINDOW, 2 * d, generator=g).to("cuda")
            mask = torch.ones(b, WINDOW, dtype=torch.bool, device="cuda")
            with torch.inference_mode():
                out[f"latent{latent}_{name}_ms"] = _ms(torch, lambda: block(x))
                out[f"latent{latent}_{name}_gru1_ms"] = _ms(torch, lambda: block.gru1(y, mask))
            del block, x, y
            torch.cuda.empty_cache()
    return out


def _quartiles(v):
    q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
    return {"median": q[1], "q1": q[0], "q3": q[2]}


def summarize(paths) -> dict:
    out, paths_runs = {}, []
    for path in paths:
        lines = [json.loads(line) for line in open(path) if line.startswith("{")]
        runs = [r for r in lines if "total_s" in r]
        blocks_ = [r["blocks"] for r in lines if "blocks" in r]
        paths_runs.append(runs)
        res = {"runs": len(runs), "card": sorted({r["card"] for r in lines})}
        if runs:
            res["total_s"] = _quartiles([r["total_s"] for r in runs])
            res["embed_s"] = _quartiles([r["stages_s"]["embed"] for r in runs])
            res["frames_per_s"] = _quartiles([r["frames_per_s"] for r in runs])
        for key in blocks_[0] if blocks_ else []:
            res[key] = statistics.median(b[key] for b in blocks_)
        out[path] = res
    if len(paths) == 2:
        a, b = paths_runs
        pairs = list(zip(a, b))
        out["pairs"] = len(pairs)
        out["pairs_won"] = {paths[0]: sum(x["total_s"] < y["total_s"] for x, y in pairs),
                            paths[1]: sum(y["total_s"] < x["total_s"] for x, y in pairs)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", metavar="ROOT", help="tree whose RecurrentBlock to time")
    ap.add_argument("--latents", type=int, nargs="+", default=[4, 8, 16, 64])
    ap.add_argument("--summarize", metavar="FILE", nargs="+", help="files of JSON lines, one per tree")
    args = ap.parse_args()
    if args.summarize:
        print(json.dumps(summarize(args.summarize), indent=1))
        return 0
    if not args.blocks:
        ap.error("--blocks or --summarize is required")
    import torch

    if not torch.cuda.is_available():
        print("torch_ab_path: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    res = blocks(args.blocks, args.latents)
    print(card)
    print(json.dumps({"root": args.blocks, "card": card, "blocks": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
