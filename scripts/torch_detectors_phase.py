"""chip_smoke.py's detectors phase (17) alone, on one CUDA GPU, from seeded
inputs at phase 15's shapes: 10,000 chunks x 517 chunk statistics (a
twelfth of the columns rounded to few values, sparse NaNs, 17 columns 30%
NaN), 10 labels of skewed sizes drawn from a noisy softmax of six columns,
three recordings of 3,700 / 3,300 / 3,000 chunks, and 80,928 latent-8
embeddings with random labels for compute_UMAP.

    python3 scripts/torch_detectors_phase.py [--out FILE] [--profile]

Prints the card's name and power limit, then the phase's JSON line
(``"path": "detectors"``; ``--out`` also writes it to FILE). ``--profile``
then fits the full detector once more under ``torch.profiler`` and prints
its wall seconds, the device time of each kernel (sum, launches), the
device's busy share of the wall time, the trees' rounds and the host reads.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CHUNKS, STATISTICS, LABELS = 10_000, 517, 10
RECORDINGS = (3_700, 3_300, 3_000)
EMBEDDINGS = (80_928, 8)


def seeded_inputs(seed: int = 0):
    """((statistics Labelled, labels, bin_info), embeddings, their labels)."""
    from deepof_tpu_torch.posthoc import Labelled

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(CHUNKS, STATISTICS))
    x[:, 40:80] = np.round(x[:, 40:80])
    x[rng.random(x.shape) < 0.002] = np.nan
    x[:, 500:] = np.where(rng.random((CHUNKS, STATISTICS - 500)) < 0.3, np.nan, x[:, 500:])
    logits = (x[:, :6] @ rng.normal(size=(6, LABELS)) + 1.5 * rng.normal(size=(CHUNKS, LABELS))
              + np.log(np.linspace(1, 12, LABELS)))
    y = logits.argmax(1)
    stats = Labelled(x, list(range(CHUNKS)), [f"c{i}" for i in range(STATISTICS)])
    bin_info = {key: np.arange(n) for key, n in zip(("test", "test2", "test3"), RECORDINGS)}
    emb = rng.normal(size=EMBEDDINGS)
    return (stats, y, bin_info), emb, rng.integers(0, LABELS, EMBEDDINGS[0])


def profile_fit(torch, chunks) -> dict:
    """One full detector fit under the profiler: wall seconds, each
    kernel's device ms and launches, the device's busy share, rounds and
    host reads."""
    from torch.profiler import ProfilerActivity, profile

    from deepof_tpu_torch import posthoc as ph

    stats, y, _ = chunks
    np.random.seed(0)
    clf = ph._make_cluster_detector(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        clf.fit(stats.values, y)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    est = clf.named_steps["classifier"].estimator_
    kernels, busy_us = {}, 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if e.device_type.name != "CUDA" or dev_us <= 0:
            continue
        busy_us += dev_us
        kernels[e.key[:80]] = {"device_ms": dev_us / 1e3, "launches": e.count}
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["device_ms"])[:12])
    return {"wall_s": wall, "device_busy_share": busy_us / 1e6 / wall, "n_iter": est.n_iter_,
            "trees": len(est._ensemble.roots), "train_rows": est.n_train_, "host_reads": est.host_reads_,
            "kernels": top}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the phase's JSON line here")
    parser.add_argument("--profile", action="store_true", help="profile one more full fit")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_detectors_phase: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke
    from deepof_tpu_torch.ops import cuda_build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    cuda_build.build()
    print(f"{card}; kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    chunks, emb, labels = seeded_inputs()
    line, _ = chip_smoke._detectors_phase(torch, card, chunks, emb, labels)
    print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(json.dumps(line) + "\n")
    if args.profile:
        print(json.dumps({"profile": profile_fit(torch, chunks), "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
