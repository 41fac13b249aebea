"""Where the time of the port's serving path goes on one CUDA GPU.

    python3 scripts/torch_profile_path.py [--root ROOT] [--animals B]

Drives the same 1-hour, 2-animal serving path as chip_smoke.py (warm: one
untimed 2,000-frame and one untimed 1-hour run first, as chip_smoke.py
times it), once under torch.profiler with CPU and CUDA
activities, and prints:
- the card's name and power limit (nvidia-smi);
- the run's wall time and the device's busy share of it (the sum of kernel
  times over the wall time; kernels do not overlap on one stream);
- the kernels ranked by total device time, with launch counts.
Then, on the same scaled frame, the embed stage alone
(``scanned_windowed_forward``) under the profiler: its kernels ranked, and
its kernel launches per block of windows. Last, the conv probe: the
RecurrentBlock's first conv on the serving node streams as the block calls
it (``F.conv1d`` on the (B, F, T) transposed view of its (B, T, F) input),
every kernel it launches in order, beside the same conv on a contiguous
(B, F, T) input, to show whether cuDNN copies the view first.
The chrome trace of the path is written to chiprun_out/torch_profile_path.json.
With ``--root`` the path runs through the package and chip_smoke.py of ROOT,
a checkout of another commit of the port, and no trace is written;
``--animals B`` makes the recording one deepof_14 animal's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _kernels(torch, prof):
    """(device us, launches, name) of every CUDA kernel, by total time."""
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, evt.count, evt.key))
    return sorted(rows, reverse=True)


def _print_table(rows, top):
    busy_us = sum(r[0] for r in rows)
    print(f"{'device ms':>10} {'share':>6} {'launches':>8}  kernel")
    for us, count, key in rows[:top]:
        print(f"{us / 1e3:10.3f} {us / busy_us:6.1%} {count:8d}  {key[:110]}")


def _conv_probe(torch, profile, activities, block, window):
    """The node block's first conv at the serving block's shape, as
    RecurrentBlock calls it and on a contiguous input: kernels in order,
    with device us."""
    import torch.nn.functional as F

    b, t, f, c_out = block * 28, window, 3, 16
    g = torch.Generator().manual_seed(3)
    x = torch.randn(b, t, f, generator=g).to("cuda")
    w = torch.randn(c_out, f, 5, generator=g).to("cuda")
    xt = x.transpose(1, 2).contiguous()
    out = {}
    for name, fn in (("view", lambda: F.conv1d(x.transpose(1, 2), w, padding=2)),
                     ("contiguous", lambda: F.conv1d(xt, w, padding=2))):
        with torch.inference_mode():
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            with profile(activities=activities) as prof:
                fn()
                torch.cuda.synchronize()
        kernels = [(e.time_range.start, e.time_range.elapsed_us(), e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        out[name] = [(k, us) for _, us, k in sorted(kernels)]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="checkout of the port to profile (default: this one)")
    ap.add_argument("--animals", nargs="+", help="animal ids of the recording (default: chip_smoke.py's two)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root or REPO))
    import chip_smoke  # the serving-path setup lives there
    if args.animals:
        chip_smoke.ANIMALS = args.animals
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepof_tpu_torch.train.inference import scanned_windowed_forward

    if not torch.cuda.is_available():
        print("torch_profile_path: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    setup = chip_smoke._serving_setup(torch)
    pos, lik = chip_smoke._synthesize(chip_smoke.T_FRAMES, setup["nodes"])
    chip_smoke._run_path(torch, setup, pos[:chip_smoke.PREFIX], lik[:chip_smoke.PREFIX], "cuda")
    chip_smoke._run_path(torch, setup, pos, lik, "cuda")
    torch.cuda.synchronize()

    stages = {}
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        scaled, _, _ = chip_smoke._run_path(torch, setup, pos, lik, "cuda", stages)
        wall_s = time.perf_counter() - t0
    rows = _kernels(torch, prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    print(card)
    print(json.dumps({
        "card": card, "frames": chip_smoke.T_FRAMES, "wall_s": wall_s,
        "stages_s": stages, "device_busy_s": busy_s, "device_busy_share": busy_s / wall_s,
    }))
    _print_table(rows, 25)
    if not args.root:
        out_dir = os.path.join(REPO, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "torch_profile_path.json"))

    # The embed stage alone, on the same scaled frame.
    n_blocks = -(-(chip_smoke.T_FRAMES - chip_smoke.WINDOW + 1) // chip_smoke.BLOCK)
    fwd_args = (setup["bundle"], scaled, setup["layout"], chip_smoke.WINDOW, "VQVAE")
    scanned_windowed_forward(*fwd_args, block=chip_smoke.BLOCK)
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        scanned_windowed_forward(*fwd_args, block=chip_smoke.BLOCK)
        embed_s = time.perf_counter() - t0
    rows = _kernels(torch, prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    launches = sum(r[1] for r in rows)
    print(json.dumps({
        "embed_wall_s": embed_s, "embed_device_busy_s": busy_s, "embed_device_busy_share": busy_s / embed_s,
        "embed_launches": launches, "blocks": n_blocks, "launches_per_block": launches / n_blocks,
    }))
    _print_table(rows, 20)

    probe = _conv_probe(torch, profile, activities, chip_smoke.BLOCK, chip_smoke.WINDOW)
    print(json.dumps({"conv_probe": probe}))
    for name, kernels in probe.items():
        print(f"conv on the {name} input: " + "; ".join(f"{k[:70]} {us:.1f} us" for k, us in kernels))
    return 0


if __name__ == "__main__":
    sys.exit(main())
