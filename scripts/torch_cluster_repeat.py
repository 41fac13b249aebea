"""Whether the port's k-means fits repeat bit for bit on one CUDA GPU.

    python3 scripts/torch_cluster_repeat.py [--runs 5] [--out chiprun_out/cluster_repeat.json]

Two parts, on seeded data (numpy ``default_rng(0)``: 40 Gaussian blobs in 8
dimensions, the latent width of the soft-count decoders, 30,000 rows,
float32):

- per-cluster sums at the minibatch k-means' shapes (1,024 rows into 200
  clusters, 30,000 rows into 10 and into 200), each computed ``--runs``
  times on the card by ``gmm.cluster_sums`` and by ``index_add_``, against
  the CPU's ``index_add_`` (rows added in order): how many runs are equal
  bit for bit to the CPU's, and how many distinct results the runs gave;
- ``cluster.MiniBatchKMeans(n_clusters=200, n_init=3, random_state=0)``,
  the MSM decoder's fit at its default ``n_micro``, fitted ``--runs`` times
  on the card with ``gmm.cluster_sums`` and as often with ``index_add_`` in
  its place: the distinct centre sets, the steps each took, and the labels
  that differ from a CPU fit's.

Prints the card's name and power limit, then one JSON line (also written
to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(rows=30_000, dim=8, blobs=40):
    rng = np.random.default_rng(0)
    centres = rng.normal(scale=3.0, size=(blobs, dim))
    x = centres[rng.integers(0, blobs, rows)] + rng.normal(size=(rows, dim))
    return ((x - x.mean(0)) / x.std(0)).astype(np.float32)


def _distinct(tensors):
    """How many distinct values (bit for bit) a list of tensors holds."""
    seen = []
    for t in tensors:
        if not any(t.shape == s.shape and bool((t == s).all()) for s in seen):
            seen.append(t)
    return len(seen)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=5)
    parser.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "cluster_repeat.json"))
    args = parser.parse_args()
    sys.path.insert(0, REPO)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from deepof_tpu_torch import cluster
    from deepof_tpu_torch.train import gmm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    x = _data()
    line = {"card": card, "runs": args.runs, "sums": {}, "minibatch_kmeans": {}}

    def index_add(xs, labels, k):
        return xs.new_zeros((k, xs.shape[1])).index_add_(0, labels, xs)

    g = np.random.default_rng(1)
    for rows, k in ((1024, 200), (30_000, 10), (30_000, 200)):
        xs = torch.as_tensor(x[:rows])
        labels = torch.as_tensor(g.integers(0, k, rows))
        want = index_add(xs, labels, k)
        for name, fn in (("cluster_sums", gmm.cluster_sums), ("index_add_", index_add)):
            got = [fn(xs.cuda(), labels.cuda(), k).cpu() for _ in range(args.runs)]
            line["sums"][f"{rows}x{k}/{name}"] = {
                "equal_to_cpu": sum(bool(torch.equal(t, want)) for t in got), "distinct": _distinct(got),
                "max_abs_diff_to_cpu": max(float((t - want).abs().max()) for t in got)}

    cpu_fit = cluster.MiniBatchKMeans(n_clusters=200, n_init=3, random_state=0, device="cpu").fit(x)
    for name, fn in (("cluster_sums", gmm.cluster_sums), ("index_add_", index_add)):
        gmm.cluster_sums, original = fn, gmm.cluster_sums
        try:
            fits = [cluster.MiniBatchKMeans(n_clusters=200, n_init=3, random_state=0, device="cuda").fit(x)
                    for _ in range(args.runs)]
        finally:
            gmm.cluster_sums = original
        line["minibatch_kmeans"][name] = {
            "distinct_centres": _distinct([f.cluster_centers_.cpu() for f in fits]),
            "steps": [f.n_steps_ for f in fits],
            "labels_differing_from_cpu": [int((f.labels_.cpu() != cpu_fit.labels_).sum()) for f in fits]}
    line["minibatch_kmeans"]["cpu_steps"] = cpu_fit.n_steps_

    print(card)
    text = json.dumps(line)
    print(text)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
