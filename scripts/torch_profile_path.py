"""Where the time of the port's serving path goes on one CUDA GPU.

    python3 scripts/torch_profile_path.py

Drives the same 1-hour, 2-animal serving path as chip_smoke.py (warm: one
untimed 2,000-frame run first), once under torch.profiler with CPU and CUDA
activities, and prints:
- the card's name and power limit (nvidia-smi);
- the run's wall time and the device's busy share of it (the sum of kernel
  times over the wall time; kernels do not overlap on one stream);
- the kernels ranked by total device time, with launch counts.
The chrome trace is written to chiprun_out/torch_profile_path.json.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (the serving-path setup lives there)


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_path: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    setup = chip_smoke._serving_setup(torch)
    pos, lik = chip_smoke._synthesize(chip_smoke.T_FRAMES, setup["nodes"])
    chip_smoke._run_path(torch, setup, pos[:chip_smoke.PREFIX], lik[:chip_smoke.PREFIX], "cuda")
    torch.cuda.synchronize()

    stages = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chip_smoke._run_path(torch, setup, pos, lik, "cuda", stages)
        wall_s = time.perf_counter() - t0
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((us, evt.count, evt.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    print(card)
    print(json.dumps({
        "card": card, "frames": chip_smoke.T_FRAMES, "wall_s": wall_s,
        "stages_s": stages, "device_busy_s": busy_s, "device_busy_share": busy_s / wall_s,
    }))
    print(f"{'device ms':>10} {'share':>6} {'launches':>8}  kernel")
    for us, count, key in rows[:25]:
        print(f"{us / 1e3:10.3f} {us / 1e6 / busy_s:6.1%} {count:8d}  {key[:110]}")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "torch_profile_path.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
