"""The HMM scan's two routes timed against each other on one CUDA GPU, over
a grid of sequences N, states K and frames T: the data behind the chunk
rule of ``deepof_tpu_torch/csrc/hmm_scan.cu`` (``chunked``).

    python3 scripts/torch_hmm_plan.py [--out FILE]

Builds two variants of the checkout's ``csrc/hmm_scan.cu`` into the
git-ignored ``build/cuda_hmm_plan``, its rule replaced by "always chunk"
and by "never chunk" (one chunk: the serial chain of log-sum-exps a
sequence and direction), and serves ``hmm_scan`` from each in turn
(``cuda_build.use``). At every shape it times the wrapper with CUDA events
(3 calls after 1 warm one), in the order serial, chunked, chunked, serial,
on seeded inputs made on the card (emissions of -5 +- 3 nats, a
diagonal-heavy transition matrix), with the routes' largest difference
over max(1, |serial|). Prints the card's name and power limit,
then one JSON line a shape: both routes' times, their ratio, and the
chunked route's plan; ``--out`` also writes the lines to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEQUENCES = (1, 3, 8, 24, 64, 128)
STATES = (2, 4, 8, 10, 16, 20, 25, 32)
FRAMES = (1000, 5000, 45000)
# The cohort's states="bic" scan: 3 recordings of 26,976 windows, 2-25 states.
BIC = [(3, 26976, k) for k in range(2, 26)]
RULE = re.compile(r"(bool chunked\(int n, int k, int sms\) \{\n)(.*?)(\n\})", re.S)


def _variant(src: str, always: bool) -> str:
    out, hits = RULE.subn(lambda m: m.group(1) + f"    return {'true' if always else 'false'};" + m.group(3), src)
    if hits != 1:
        raise RuntimeError("the chunk rule `chunked(n, k, sms)` was not found in csrc/hmm_scan.cu")
    return out


def _ms(torch, fn, reps=3):
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_hmm_plan: no CUDA device is available", file=sys.stderr)
        return 2
    from deepof_tpu_torch.ops import cuda_build
    from deepof_tpu_torch.ops import hmm_kernels as hk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    src = open(os.path.join(cuda_build.CSRC_DIR, "hmm_scan.cu")).read()
    out_dir = os.path.join(ROOT, "build", "cuda_hmm_plan")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, always in (("chunked", True), ("serial", False)):
        path = os.path.join(out_dir, name)
        with open(path + ".cu", "w") as fh:
            fh.write(_variant(src, always))
        procs[name] = (path + ".so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", path + ".so", path + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = so

    def route(name):
        cuda_build.use("hmm_scan", libs[name])
        hk._plan.cache_clear()

    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(n, t, k) for t in FRAMES for k in STATES for n in SEQUENCES] + BIC
    sink = open(args.out, "w") if args.out else None
    try:
        for n, t, k in shapes:
            log_b = torch.randn(n, t, k, generator=g, device="cuda") * 3 - 5
            a = torch.rand(k, k, generator=g, device="cuda") + torch.eye(k, device="cuda") * k
            pi = torch.rand(k, generator=g, device="cuda")
            args_ = (log_b, torch.log(pi / pi.sum()), torch.log(a / a.sum(1, keepdim=True)))
            times = {"serial": [], "chunked": []}
            for name in ("serial", "chunked", "chunked", "serial"):
                route(name)
                times[name].append(_ms(torch, lambda: hk.hmm_scan(*args_)))
            route("chunked")
            plan = hk.hmm_scan_config(n, t, k)
            got = hk.hmm_scan(*args_)
            route("serial")
            want = hk.hmm_scan(*args_)
            err = max(float(((x - y).abs() / y.abs().clamp(min=1.0)).max()) for x, y in zip(got, want))
            serial, chunked = min(times["serial"]), min(times["chunked"])
            line = {"n": n, "t": t, "k": k, "serial_ms": serial, "chunked_ms": chunked,
                    "chunked_over_serial": chunked / serial, "times_ms": times, "chunk": plan["chunk"],
                    "chunks": plan["chunks"], "routes_max_rel_diff": err, "card": card}
            print(json.dumps(line), flush=True)
            if sink:
                sink.write(json.dumps(line) + "\n")
            del log_b, got, want, args_
    finally:
        if sink:
            sink.close()
        cuda_build.use("hmm_scan", None)
        hk._plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
