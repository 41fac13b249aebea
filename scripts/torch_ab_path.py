"""A/B of the port between two trees on one CUDA GPU: the serving path's
seconds, the RecurrentBlock's time at several latents, and the GRU
backward's gradient products at the training shapes.

    python3 scripts/torch_ab_path.py --path ROOT
    python3 scripts/torch_ab_path.py --blocks ROOT [--latents 4 8 16 64]
    python3 scripts/torch_ab_path.py --products ROOT
    python3 scripts/torch_ab_path.py --summarize A.jsonl B.jsonl

``--path`` drives the serving path of chip_smoke.py through ROOT's own
chip_smoke.py and package (a checkout of any commit of the port; its
kernels build into ROOT/build/cuda), with nothing else in the process:
the setup and one untimed 2,000-frame run, then, after emptying the caching
allocator, two timed 1-hour runs. The first pays the cudaMallocs of the
path's full-size buffers, as a process that embeds one recording does; the
second reuses them. Prints one stage line in the form of chip_smoke.py's
(``first_run_s`` and ``total_s``, the stages of each, and the cudaMalloc
calls of each). Only the path's own code runs before the timed runs, the
same in every tree; chip_smoke.py's own timed runs follow its kernel
checks, which differ between trees.

``--blocks`` times, through ROOT's own modules, the serving encoder's node
block (4096 x 28 streams, 3 features) and edge block (4096 x 32 streams, 1
feature) at each latent: ``RecurrentBlock.forward``, and its first BiGRU
alone (``gru1(x, mask)``), with every window full; CUDA events over 10
calls after 2 warm ones.

``--products`` times, through ROOT's own ``ops.gru_kernels``, the GRU
backward's gradient products (``_gradient_products``: dx and the weight
gradients from the gate gradients) at the six GRU shapes of a batch-256
training step (``PRODUCT_SHAPES``, D = 2, T = 25), on seeded random inputs;
CUDA events over 20 calls after 2 warm ones, with no spin of the card
first, so a call whose host work outlasts its kernels reads its host time,
as it does inside the host-bound train step.

All three print the card's name and power limit, then one JSON line.

``--summarize`` reads files of JSON lines, one file per tree, each line
either a stage line (chip_smoke.py's or --path's, the one with "total_s")
or a --blocks or --products line, written in turns (A, B, B, A, ...). Prints per file the
median and quartiles of the path's seconds (the first run's too, where the
lines have it), embed seconds and frames/s, and the median block times;
with two files, how many of the paired runs (the k-th line of one file
against the k-th of the other) each tree won. A call on the card, with the
other tree unpacked into the git-ignored build/parent:

    for root in build/parent . . build/parent; do
      (cd $root && python3 chip_smoke.py) | grep '"total_s"' >> chiprun_out/ab_$(basename $root).jsonl
      python3 scripts/torch_ab_path.py --path $root | grep total_s >> chiprun_out/path_$(basename $root).jsonl
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
# (B, F, H) of the GRU layers of a batch-256 training step: the encoder's
# node and edge gru1 and gru2, the decoder's two layers.
PRODUCT_SHAPES = [(256 * 28, 16, 16), (256 * 28, 32, 8), (256 * 32, 16, 16), (256 * 32, 32, 8),
                  (256, 8, 8), (256, 16, 16)]


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


def path(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import time

    import torch

    import chip_smoke

    setup = chip_smoke._serving_setup(torch)
    pos, lik = chip_smoke._synthesize(chip_smoke.T_FRAMES, setup["nodes"])
    chip_smoke._run_path(torch, setup, pos[:chip_smoke.PREFIX], lik[:chip_smoke.PREFIX], "cuda")
    torch.cuda.empty_cache()
    runs = []
    for _ in range(2):
        stages = {}
        mallocs = torch.cuda.memory_stats().get("segment.all.allocated", 0)
        t0 = time.perf_counter()
        chip_smoke._run_path(torch, setup, pos, lik, "cuda", stages)
        total_s = time.perf_counter() - t0
        runs.append((stages, total_s, torch.cuda.memory_stats().get("segment.all.allocated", 0) - mallocs))
    (first_stages, first_s, first_mallocs), (stages, total_s, mallocs) = runs
    return {"stages_s": stages, "total_s": total_s, "frames_per_s": chip_smoke.T_FRAMES / total_s,
            "cuda_mallocs": mallocs, "first_stages_s": first_stages, "first_run_s": first_s,
            "first_frames_per_s": chip_smoke.T_FRAMES / first_s, "first_cuda_mallocs": first_mallocs}


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


def products(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from deepof_tpu_torch.ops.gru_kernels import _gradient_products

    g = torch.Generator().manual_seed(2)
    out = {}
    for b, f, h in PRODUCT_SHAPES:
        x, wi, hs, dg, dhn = (torch.randn(*shape, generator=g).to("cuda") for shape in (
            (b, WINDOW, f), (2, f, 3 * h), (b, WINDOW, 2, h), (b, WINDOW, 2, 3 * h), (b, WINDOW, 2, h)))
        out[f"b{b}_f{f}_h{h}_ms"] = _ms(torch, lambda: _gradient_products(x, wi, hs, dg, dhn), reps=20)
    return out


def _quartiles(v):
    q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
    return {"median": q[1], "q1": q[0], "q3": q[2]}


def summarize(paths) -> dict:
    out, paths_runs = {}, []
    for path in paths:
        lines = [json.loads(line) for line in open(path) if line.startswith("{")]
        runs = [r for r in lines if "total_s" in r]
        blocks_ = [r.get("blocks") or r["products"] for r in lines if "blocks" in r or "products" in r]
        paths_runs.append(runs)
        res = {"runs": len(runs), "card": sorted({r["card"] for r in lines})}
        if runs:
            res["total_s"] = _quartiles([r["total_s"] for r in runs])
            res["embed_s"] = _quartiles([r["stages_s"]["embed"] for r in runs])
            res["frames_per_s"] = _quartiles([r["frames_per_s"] for r in runs])
        firsts = [r for r in runs if "first_run_s" in r]
        if firsts:
            res["first_run_s"] = _quartiles([r["first_run_s"] for r in firsts])
            res["first_embed_s"] = _quartiles([r["first_stages_s"]["embed"] for r in firsts])
            res["first_frames_per_s"] = _quartiles([r["first_frames_per_s"] for r in firsts])
        for key in blocks_[0] if blocks_ else []:
            res[key] = statistics.median(b[key] for b in blocks_)
        out[path] = res
    if len(paths) == 2:
        a, b = paths_runs
        pairs = list(zip(a, b))
        out["pairs"] = len(pairs)
        for key in ("total_s", "first_run_s"):
            both = [(x[key], y[key]) for x, y in pairs if key in x and key in y]
            if both:
                out[f"pairs_won_{key}"] = {paths[0]: sum(x < y for x, y in both),
                                           paths[1]: sum(y < x for x, y in both)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--blocks", metavar="ROOT", help="tree whose RecurrentBlock to time")
    ap.add_argument("--path", metavar="ROOT", help="tree whose serving path to time")
    ap.add_argument("--products", metavar="ROOT", help="tree whose GRU gradient products to time")
    ap.add_argument("--latents", type=int, nargs="+", default=[4, 8, 16, 64])
    ap.add_argument("--summarize", metavar="FILE", nargs="+", help="files of JSON lines, one per tree")
    args = ap.parse_args()
    if args.summarize:
        print(json.dumps(summarize(args.summarize), indent=1))
        return 0
    if not (args.blocks or args.path or args.products):
        ap.error("--blocks, --path, --products or --summarize is required")
    import torch

    if not torch.cuda.is_available():
        print("torch_ab_path: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    if args.path:
        print(json.dumps({"root": args.path, "card": card, **path(args.path)}), flush=True)
    elif args.products:
        print(json.dumps({"root": args.products, "card": card, "products": products(args.products)}), flush=True)
    else:
        print(json.dumps({"root": args.blocks, "card": card, "blocks": blocks(args.blocks, args.latents)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
