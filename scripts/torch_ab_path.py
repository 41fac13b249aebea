"""A/B of the port between two trees on one CUDA GPU: the serving path's
seconds, the RecurrentBlock's time at several latents, the GRU layer's
backward at the training shapes, the HMM and Kalman/RTS kernels, and the
gradient-boosted tree fit.

    python3 scripts/torch_ab_path.py --path ROOT
    python3 scripts/torch_ab_path.py --blocks ROOT [--latents 4 8 16 64]
    python3 scripts/torch_ab_path.py --backward ROOT
    python3 scripts/torch_ab_path.py --hmm ROOT
    python3 scripts/torch_ab_path.py --softcounts ROOT
    python3 scripts/torch_ab_path.py --kalman ROOT [--chunks 32 64 107 213]
    python3 scripts/torch_ab_path.py --gbm ROOT
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

``--backward`` times, through ROOT's own ``ops.gru_kernels``, the GRU
layer's backward wrapper (``gru_scan_backward``: dx and the weight
gradients from the carries; whatever a tree's wrapper launches for them)
at the six GRU shapes of a batch-256 training step (``BACKWARD_SHAPES``, D
= 2, T = 25, full windows, output and final-carry gradients), on seeded
random inputs; CUDA events over 20 calls after 2 warm ones, with no spin
of the card first, so a call whose host work outlasts its kernels reads
its host time, as it does inside the host-bound train step.

``--hmm`` times, through ROOT's own ``ops.hmm_kernels``, ``hmm_scan`` at
``HMM_SHAPES``: the cohort's 3 recordings of 26,976 windows and the lab
cohort's 24 of 45,000 frames, at 10, 25 and 32 states, on seeded inputs
made on the card; CUDA events over 3 calls after 1 warm one.

``--softcounts`` runs ROOT's own chip_smoke.py phase 9 (the cohort's
create and VaDE fit), then times, through ROOT's own package and
without phase 11's kernel checks, each soft-count call of phase 11 on
that cohort ``SOFTCOUNT_REPS`` times (``embedding_per_video`` with each
of the four methods, ``recluster``, the states="bic" scan), and the lab
cohort's HMM and MSM fits (phase 11's ``_softcounts_lab_cohort``, the
same seeded data in every tree). Prints each call's median seconds and
the lab MSM fit's minibatch steps (a host read each).

``--kalman`` times, through ROOT's own ``ops.kalman_kernels``,
``kalman_rts`` at ``KALMAN_SHAPES``: one animal's block of a public
recording (45,000, 28), both animals' (45,000, 56) and a 2-hour animal
(180,000, 28), seeded random walks made on the host; CUDA events over 10
calls after 2 warm ones, ``ms`` after a ~20 ms spin of the card (the
device's time: the host has queued every call before the first starts)
and ``wrapper_ms`` without it (a call's host work included). With
``--chunks L ...`` (a tree whose ``kalman_rts_config`` takes ``chunk``)
it times each chunk length L instead of the tree's own plan (``ms``
only), each call's output held against the tree's own plan's at 1e-5 of
max(1, |value|).

``--gbm`` times, through ROOT's own ``ops.gbm_kernels``, the tree fit's
histogram and split kernels at chip_smoke.py's three seeded rounds
(``GBM_SHAPES``, built by this tree's ``_gbm_round``) of the real fit's
``GBM_SIZE`` (26,712 rows, 495 features, 10 trees): the histograms with
their siblings' subtraction (``hist_ms``: in the kernel, or a tree's kernel
then its torch subtraction; ``hist_kernel_ms``: the kernel alone), and
the split search over the round's children; CUDA events over 5 calls after a warm one, and a digest
of each output (equal digests: equal bits across trees). Then one full
detector fit at ``scripts/torch_detectors_phase.py``'s seeded shapes
(ROOT's own script and ``posthoc._make_cluster_detector``), once as it
runs and once under ``torch.profiler``: wall seconds, the device's busy
share, each tree-fit kernel's device ms and launches, host-to-device
copies, rounds (split launches) and, a round, launches and uploads.

All seven print the card's name and power limit, then one JSON line.

``--summarize`` reads files of JSON lines, one file per tree, each line
either a stage line (chip_smoke.py's or --path's, the one with "total_s")
or a --blocks, --backward, --hmm, --softcounts, --kalman or --gbm line,
written in turns (A, B, B, A, ...). Prints per file the
median and quartiles of the path's seconds (the first run's too, where the
lines have it), embed seconds and frames/s, and the median block times
(with --gbm lines, whether each tree's runs gave the same digests, and
with two files, which digests the trees share);
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
BACKWARD_SHAPES = [(256 * 28, 16, 16), (256 * 28, 32, 8), (256 * 32, 16, 16), (256 * 32, 32, 8),
                  (256, 8, 8), (256, 16, 16)]

# (N, T, K) of hmm_scan's calls: the cohort's and the lab cohort's lengths.
HMM_SHAPES = [(n, t, k) for n, t in ((3, 26976), (24, 45000)) for k in (10, 25, 32)]
# (T, C) of kalman_rts's calls: one and two animals of a public recording,
# one animal of a 2-hour recording.
KALMAN_SHAPES = [(45000, 28), (45000, 56), (180000, 28)]
MODES = ("blocks", "backward", "hmm", "softcounts", "kalman", "gbm")
# (n, F, K) of the tree fit's rounds: the full detector's fit on the real
# cohort (its 26,712 training rows after SMOTE, 495 statistics, 10 labels).
GBM_SIZE = (26_712, 495, 10)
SPIN_CYCLES = 40_000_000  # ~20 ms at the H100's ~1.98 GHz boost clock
SOFTCOUNT_REPS = 3


def _ms(torch, fn, reps: int = 10, warmup: int = 2, spin: bool = False) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
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


def backward(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from deepof_tpu_torch.ops.gru_kernels import gru_scan_backward, gru_scan_carries

    g = torch.Generator().manual_seed(2)
    out = {}
    for b, f, h in BACKWARD_SHAPES:
        x, wi, bi, wh, bhn, d_out, d_fin = (torch.randn(*shape, generator=g).to("cuda") / 4 for shape in (
            (b, WINDOW, f), (2, f, 3 * h), (2, 3 * h), (2, h, 3 * h), (2, h), (b, WINDOW, 2 * h), (b, 2 * h)))
        mask = torch.ones(b, WINDOW, dtype=torch.bool, device="cuda")
        _, _, hs = gru_scan_carries(x, mask, wi, bi, wh, bhn, (False, True))
        out[f"b{b}_f{f}_h{h}_ms"] = _ms(
            torch, lambda: gru_scan_backward(x, mask, wi, bi, wh, bhn, (False, True), hs, d_out, d_fin), reps=20)
    return out


def hmm(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    from deepof_tpu_torch.ops.hmm_kernels import hmm_scan

    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for n, t, k in HMM_SHAPES:
        log_b = torch.randn(n, t, k, generator=g, device="cuda") * 3 - 5
        a = torch.rand(k, k, generator=g, device="cuda") + torch.eye(k, device="cuda") * k
        pi = torch.rand(k, generator=g, device="cuda")
        args = (log_b, torch.log(pi / pi.sum()), torch.log(a / a.sum(1, keepdim=True)))
        out[f"n{n}_t{t}_k{k}_ms"] = _ms(torch, lambda: hmm_scan(*args), reps=3, warmup=1)
    return out


def kalman(root: str, chunks=None) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import functools

    import numpy as np
    import torch

    from deepof_tpu_torch.ops import kalman_kernels
    from deepof_tpu_torch.ops.kalman_kernels import kalman_rts

    rng = np.random.default_rng(0)
    out = {}
    for t, c in KALMAN_SHAPES:
        z = torch.as_tensor((rng.normal(size=(t, c)).cumsum(axis=0) * 2.0 + 300.0).astype(np.float32), device="cuda")
        if not chunks:
            out[f"t{t}_c{c}_ms"] = _ms(torch, lambda: kalman_rts(z), spin=True)
            out[f"t{t}_c{c}_wrapper_ms"] = _ms(torch, lambda: kalman_rts(z))
            continue
        want = kalman_rts(z)
        plan = kalman_kernels.kalman_rts_config
        try:
            for length in chunks:
                kalman_kernels.kalman_rts_config = functools.partial(plan, chunk=length)
                err = float(((kalman_rts(z) - want).abs() / want.abs().clamp(min=1.0)).max())
                if not err <= 1e-5:
                    raise SystemExit(f"kalman_rts at chunk {length}, {(t, c)}: {err} off the tree's own plan")
                out[f"t{t}_c{c}_L{length}_ms"] = _ms(torch, lambda: kalman_rts(z), spin=True)
        finally:
            kalman_kernels.kalman_rts_config = plan
    return out


def softcounts(root: str, card: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import shutil
    import tempfile
    import time

    import torch

    import chip_smoke as cs
    from deepof_tpu_torch import posthoc as ph
    from deepof_tpu_torch.train.inference import embedding_per_video

    tmp = tempfile.mkdtemp(prefix="ab_softcounts_")
    times = {}
    try:
        _, _, cohort = cs._cohort_phase(torch, card, tmp)
        coords, (_, meta, _, tab_dict, scaler), bundle = (cohort["coords"], cohort["graph_dataset"],
                                                          cohort["bundle"])
        for _ in range(SOFTCOUNT_REPS):
            emb = None
            for method in cs.SOFTCOUNT_METHODS:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                emb, _ = embedding_per_video(coords, tab_dict, bundle, meta, animal_id="B", global_scaler=scaler,
                                             batch_size=cs.BLOCK, softcounts_extraction_method=method)
                times.setdefault(f"{method}_s", []).append(time.perf_counter() - t0)
            for name, fn in (("recluster", lambda: ph.recluster(coords, emb, states=cs.N_COMPONENTS, save=False)),
                             ("contrastive_bic", lambda: ph.get_contrastive_soft_counts(
                                 coords, emb, states="bic", max_states=cs.CONTRASTIVE_MAX_STATES))):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times.setdefault(f"{name}_s", []).append(time.perf_counter() - t0)
        lab = cs._softcounts_lab_cohort(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {**{key: statistics.median(v) for key, v in times.items()},
            "lab_hmm_fit_s": lab["hmm"]["fit_s"], "lab_msm_fit_s": lab["msm"]["fit_s"],
            "lab_msm_steps": lab["msm"]["minibatch_steps_and_host_reads"]}


def _module_at(name: str, path: str):
    """The module in the file at ``path``, imported as ``name``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def gbm(root: str) -> tuple:
    """ROOT's tree-fit kernels at the three seeded rounds, then one full
    detector fit plain and profiled. Returns (numbers, digests)."""
    sys.path.insert(0, os.path.abspath(root))
    import hashlib
    import time

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepof_tpu_torch import posthoc as ph
    from deepof_tpu_torch.ops import cuda_build
    from deepof_tpu_torch.ops import gbm_kernels as gk

    here = _module_at("chip_smoke_here", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                                       "chip_smoke.py"))
    phase = _module_at("detectors_phase_root", os.path.join(os.path.abspath(root), "scripts",
                                                            "torch_detectors_phase.py"))
    cuda_build.load("gbm")
    fused = hasattr(gk, "TASK_WIDTH")  # the parent's kernel takes (tree, node, slot) and bins (F, n)
    n, f, k = GBM_SIZE
    dev = torch.device("cuda")
    out, digests = {}, {}

    def digest(t):
        return hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()[:16]

    for shape, share in here.GBM_SHAPES.items():
        r = here._gbm_round(n, f, k, share)
        g, h = (torch.as_tensor(r[c], device=dev) for c in ("g", "h"))
        if fused:
            bins = torch.zeros((n, gk.padded_width(f)), dtype=torch.uint8, device=dev)
            bins[:, :f] = torch.as_tensor(r["bins"], device=dev).T
        else:
            bins = torch.as_tensor(r["bins"], device=dev)
            g, h = g.T.contiguous(), h.T.contiguous()
        *setup, (ids_np, tasks_np) = r["rounds"]
        ids = torch.as_tensor(ids_np, device=dev)
        tasks = torch.as_tensor(tasks_np if fused else tasks_np[:, :3], device=dev)
        sub = tasks_np[:, 3] >= 0
        par = torch.as_tensor(tasks_np[sub, 3], device=dev).long()
        sib = torch.as_tensor(tasks_np[sub, 2], device=dev).long()
        pool = torch.zeros((2 * k, f, gk.N_BINS, 3), dtype=torch.float64, device=dev)
        for ids_s, tasks_s in setup:
            gk.gbm_histograms(bins, g, h, torch.as_tensor(ids_s, device=dev),
                              torch.as_tensor(tasks_s if fused else tasks_s[:, :3], device=dev), pool)
        start = pool.clone()

        def kernel():
            gk.gbm_histograms(bins, g, h, ids, tasks, pool)

        def with_subtraction():
            kernel()
            if not fused and len(par):
                pool[par] = pool[par] - pool[sib]

        pool.copy_(start)
        with_subtraction()
        digests[f"{shape}_hist"] = digest(pool)
        out[f"{shape}_hist_ms"] = _ms(torch, with_subtraction, reps=5, warmup=1, spin=True)
        out[f"{shape}_hist_kernel_ms"] = _ms(torch, kernel, reps=5, warmup=1, spin=True)
        pool.copy_(start)
        with_subtraction()
        checked = pool.cpu()
        slots, nodes = here._gbm_split_jobs(checked, ids_np, tasks_np, n)
        slots, nodes = slots.to(dev), nodes.to(dev)
        nbnm = torch.as_tensor(r["nbnm"], device=dev)
        miss = torch.as_tensor(r["has_missing"].astype(np.uint8), device=dev)
        digests[f"{shape}_split"] = digest(gk.gbm_best_split(pool, slots, nodes, nbnm, miss))
        out[f"{shape}_split_ms"] = _ms(torch, lambda: gk.gbm_best_split(pool, slots, nodes, nbnm, miss), reps=5,
                                       warmup=1, spin=True)
        del bins, g, h, pool, start
        torch.cuda.empty_cache()

    chunks, _, _ = phase.seeded_inputs()
    stats, y, _ = chunks
    for profiled in (False, True):
        np.random.seed(0)
        clf = ph._make_cluster_detector(0)
        torch.cuda.synchronize()
        if not profiled:
            t0 = time.perf_counter()
            clf.fit(stats.values, y)
            torch.cuda.synchronize()
            out["fit_s"] = time.perf_counter() - t0
            continue
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            clf.fit(stats.values, y)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    est = clf.named_steps["classifier"].estimator_
    busy_us, launches, copies = 0.0, 0, 0
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if e.device_type.name != "CUDA" or dev_us <= 0:
            continue
        busy_us += dev_us
        if e.key.startswith("Memcpy HtoD"):
            copies += e.count
        elif not e.key.startswith(("Memcpy", "Memset")):
            launches += e.count
        for name in ("gbm_histograms", "gbm_best_split", "gbm_predict"):
            if name in e.key:
                out[f"fit_{name}_ms"] = out.get(f"fit_{name}_ms", 0.0) + dev_us / 1e3
                out[f"fit_{name}_launches"] = out.get(f"fit_{name}_launches", 0) + e.count
    rounds = max(out.get("fit_gbm_best_split_launches", 0), 1)
    out.update({"fit_profiled_s": wall, "fit_device_busy_share": busy_us / 1e6 / wall, "fit_n_iter": est.n_iter_,
                "fit_train_rows": est.n_train_, "fit_host_reads": est.host_reads_, "fit_rounds": rounds,
                "fit_launches_per_round": launches / rounds, "fit_h2d_copies": copies,
                "fit_uploads_per_round": copies / rounds})
    return out, digests


def _quartiles(v):
    q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
    return {"median": q[1], "q1": q[0], "q3": q[2]}


def summarize(paths) -> dict:
    out, paths_runs, paths_digests = {}, [], []
    for path in paths:
        lines = [json.loads(line) for line in open(path) if line.startswith("{")]
        runs = [r for r in lines if "total_s" in r]
        blocks_ = [r[m] for r in lines for m in MODES if m in r]
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
        digests = [r["digests"] for r in lines if "digests" in r]
        if digests:  # --gbm: every run of a tree gives the same bits
            res["digests_agree"] = all(d == digests[0] for d in digests)
            paths_digests.append(digests[0])
        out[path] = res
    if len(paths_digests) == 2:
        out["digests_equal_across_trees"] = {key: paths_digests[0][key] == paths_digests[1].get(key)
                                             for key in paths_digests[0]}
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
    ap.add_argument("--backward", metavar="ROOT", help="tree whose GRU backward wrapper to time")
    ap.add_argument("--hmm", metavar="ROOT", help="tree whose HMM scan to time")
    ap.add_argument("--softcounts", metavar="ROOT", help="tree whose soft-count phase to time")
    ap.add_argument("--kalman", metavar="ROOT", help="tree whose Kalman/RTS kernel to time")
    ap.add_argument("--gbm", metavar="ROOT", help="tree whose tree-fit kernels and fit to time")
    ap.add_argument("--chunks", type=int, nargs="+", help="with --kalman: chunk lengths to time")
    ap.add_argument("--latents", type=int, nargs="+", default=[4, 8, 16, 64])
    ap.add_argument("--summarize", metavar="FILE", nargs="+", help="files of JSON lines, one per tree")
    args = ap.parse_args()
    if args.summarize:
        print(json.dumps(summarize(args.summarize), indent=1))
        return 0
    if not (args.blocks or args.path or args.backward or args.hmm or args.softcounts or args.kalman or args.gbm):
        ap.error("--blocks, --path, --backward, --hmm, --softcounts, --kalman, --gbm or --summarize is required")
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
    elif args.hmm:
        print(json.dumps({"root": args.hmm, "card": card, "hmm": hmm(args.hmm)}), flush=True)
    elif args.kalman:
        print(json.dumps({"root": args.kalman, "card": card, "kalman": kalman(args.kalman, args.chunks)}), flush=True)
    elif args.gbm:
        numbers, digests = gbm(args.gbm)
        print(json.dumps({"root": args.gbm, "card": card, "gbm": numbers, "digests": digests}), flush=True)
    elif args.softcounts:
        print(json.dumps({"root": args.softcounts, "card": card, "softcounts": softcounts(args.softcounts, card)}),
              flush=True)
    elif args.backward:
        print(json.dumps({"root": args.backward, "card": card, "backward": backward(args.backward)}), flush=True)
    else:
        print(json.dumps({"root": args.blocks, "card": card, "blocks": blocks(args.blocks, args.latents)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
