"""Where the time of the port's serving path, or of one train step, goes on one CUDA GPU.

    python3 scripts/torch_profile_path.py [--root ROOT] [--animals B]
    python3 scripts/torch_profile_path.py --train [--model VaDE] [--batch 256] [--steps 20]
    python3 scripts/torch_profile_path.py --supervised
    python3 scripts/torch_profile_path.py --cohort
    python3 scripts/torch_profile_path.py --posthoc

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

With ``--train``, the step of chip_smoke.py's training phase instead
(latent 8, 10 components, window 25, two deepof_14 animals: 28 nodes, 32
edges, CensNet on, seeded weights), on a seeded batch of random windows of
that shape. It prints the card; ms per step over ``--steps`` steps (wall
clock, synchronised at the end) and the step split into its forward (loss),
backward and optimiser phases, each synchronised; the host's enqueue time of
one step, of its phases and of the GRU layer's wrappers at the node gru1
shape (7168 streams), each measured while a spin keeps the card busy, so
that no call waits for the device; PyTorch's synchronising calls in a step;
then five steps under the profiler: the device's busy share, kernel launches
a step, the kernels ranked by device time and the host operators by their
own CPU time. Its chrome trace is chiprun_out/torch_profile_train.json.
``--model VaDE`` takes VaDE's main-phase step instead of the VQ-VAE's (the
default ``VaDECfg`` weights, KL weight 0.5, its noise from a generator on
the card, the GMM's own Adam group), as chip_smoke.py's VaDE phase times
it; its trace is chiprun_out/torch_profile_train_vade.json.

With ``--supervised``, ``Coordinates.supervised_annotation`` on chip_smoke.py's
public project (2 x 45,000 frames, two deepof_14 animals, the test arenas,
ROI 1), as its supervised phase calls it: one warm call, one timed
call, then one under the profiler. It prints the card; the timed call's
wall time; the profiled call's wall time, device busy share and kernel
launches; the kernels ranked by device time, and the host operators (CUDA
runtime calls among them: launches, copies, synchronisations) by their own
CPU time. Its chrome trace is chiprun_out/torch_profile_supervised.json.

With ``--cohort``, the scaling pass of the general route on chip_smoke.py's
cohort (45,000, 36,000 and 27,000 frames of two deepof_14 animals): its
merged getter tables from ``get_graph_dataset(**GENERAL)`` (robust scaling,
groupwise sections, the second 600 s bin), then ``TableDict.preprocess``
of them, once warm, once timed, once under the profiler. It prints the
card, the timed and the profiled wall time, the device's busy share and
kernel launches, the kernels ranked by device time and the host operators
by their own CPU time. Its chrome trace is chiprun_out/torch_profile_cohort.json.

With ``--posthoc``, one post-hoc pass (chip_smoke.py ``lab_cohort_pass``:
time on cluster, mean embeddings, enrichment, per-condition transitions +
steady states) on chip_smoke.py's synthetic lab cohort (24 recordings x
45,000 frames, K 10, D 8, float64), once warm, once timed, once under the
profiler. It prints the card, the timed pass and its stages, the profiled
wall time, the device's kernel and copy seconds and their share of it,
kernel launches, the copies by kind, the kernels and copies ranked by
device time and the host operators by their own CPU time. Its chrome trace
is chiprun_out/torch_profile_posthoc.json.
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
    """(device us, launches, name) of every CUDA kernel, by total time.
    User annotations (a range around kernels, such as Optimizer.step) are
    not kernels and are left out."""
    rows = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA \
                and not getattr(evt, "is_user_annotation", False):
            rows.append((us, evt.count, evt.key))
    return sorted(rows, reverse=True)


def _host_ops(torch, prof):
    """(self CPU us, calls, name) of every host operator, by total time."""
    rows = [(float(evt.self_cpu_time_total), evt.count, evt.key) for evt in prof.key_averages()
            if evt.device_type == torch.autograd.DeviceType.CPU and not getattr(evt, "is_user_annotation", False)]
    return sorted(rows, reverse=True)


def _print_table(rows, top, per: int = 1, what: str = "kernel"):
    """The first ``top`` rows, times and counts divided by ``per`` (steps)."""
    busy_us = sum(r[0] for r in rows)
    unit = "/step" if per > 1 else ""
    print(f"{'ms' + unit:>10} {'share':>6} {'calls' + unit:>10}  {what}")
    for us, count, key in rows[:top]:
        print(f"{us / 1e3 / per:10.4f} {us / busy_us:6.1%} {count / per:10.1f}  {key[:110]}")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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


def _train_step(torch, model_name, model, x, a):
    """(optimiser, step(), loss()) of ``model_name``'s train step on one
    batch: the VQ-VAE's, or VaDE's main-phase step."""
    from deepof_tpu_torch.train import harness

    if model_name == "VQVAE":
        opt = harness.ClippedAdam(model.parameters(), 3e-4)
        step = harness.make_vqvae_step(model, opt)
        return opt, lambda: step(x, a), lambda: harness.vqvae_loss(model, x, a)[0]
    from deepof_tpu_torch.train.config import CommonFitCfg, TurtleTeacherCfg, VaDECfg
    from deepof_tpu_torch.train.losses import vade_params_from_cfg

    params = vade_params_from_cfg(CommonFitCfg(n_components=model.latent_space.n_components), VaDECfg(),
                                  TurtleTeacherCfg(), pretrain=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    opt = harness._make_optimizer(model.named_parameters(), 3e-4, gmm_lr=1e-3)
    step = harness.make_vade_step(model, opt, params, gen)
    return (opt, lambda: step(x, a, kl_weight=0.5),
            lambda: harness.vade_step_loss(model, x, a, None, params, 0.5, generator=gen)[0])


def _profile_train(torch, chip_smoke, batch: int, steps: int, model_name: str = "VQVAE") -> None:
    """The ``--train`` mode (see the module's docstring)."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from deepof_tpu_torch.models import build_model
    from deepof_tpu_torch.ops import gru_kernels as gk

    card = _card()
    graph, *_ = chip_smoke._frame_layout(chip_smoke.ANIMALS)
    n, e, w = graph.n_nodes, graph.n_edges, chip_smoke.WINDOW
    g = torch.Generator().manual_seed(0)
    x = torch.randn(batch, w, n, 3, generator=g).to("cuda")
    a = torch.randn(batch, w, e, 1, generator=g).to("cuda")
    model = build_model(model_name, (w, n, 3), (w, e, 1), graph.adjacency, chip_smoke.LATENT,
                        chip_smoke.N_COMPONENTS, generator=torch.Generator().manual_seed(0), device="cuda")
    opt, step, loss = _train_step(torch, model_name, model, x, a)
    for _ in range(3):
        step()
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3

    phases = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for _ in range(steps):
        t0 = time.perf_counter()
        total = loss()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.zero_grad(set_to_none=False)
        total.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        phases["forward"] += (t1 - t0) * 1e3 / steps
        phases["backward"] += (t2 - t1) * 1e3 / steps
        phases["optimizer"] += (t3 - t2) * 1e3 / steps

    def enqueue_ms(fn, reps):
        """Host ms per call of ``fn`` while the card spins (~200 ms), so
        that nothing waits for the device."""
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(400_000_000)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        ms = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        return ms

    b, f, h = batch * n, 16, 16
    xs = torch.randn(b, w, f, generator=g).to("cuda")
    mask = torch.ones(b, w, dtype=torch.bool, device="cuda")
    wts = [v.to("cuda") for v in (torch.randn(2, f, 3 * h, generator=g) / 4, torch.zeros(2, 3 * h),
                                  torch.randn(2, h, 3 * h, generator=g) / 4, torch.zeros(2, h))]
    _, _, hs = gk.gru_scan_carries(xs, mask, *wts, (False, True))
    d_out = torch.randn(b, w, 2 * h, generator=g).to("cuda")
    # One step at a time: a step enqueues ~670 launches, and CUDA's launch
    # queue holds ~1,000 before the host waits. Then its phases alone: a
    # phase whose enqueue time exceeds its synchronised time waits for the
    # device somewhere.
    losses = []

    def backward():
        opt.zero_grad(set_to_none=False)
        losses.pop().backward()

    enqueue = {"step": enqueue_ms(step, 1), "forward": enqueue_ms(lambda: losses.append(loss()), 1)}
    losses[:] = [loss(), loss()]
    enqueue["backward"] = enqueue_ms(backward, 1)
    enqueue["optimizer"] = enqueue_ms(opt.step, 1)
    # PyTorch's own synchronising calls within one step (device-to-host
    # copies, nonzero, item); syncs inside cuDNN or the kernels' C launchers
    # are not seen here.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        step()
        torch.cuda.set_sync_debug_mode("default")
    sync_points = sorted({str(c.message)[:160] for c in caught if "synchroniz" in str(c.message)})
    with torch.no_grad():
        enqueue |= {
            "gru_scan_serving": enqueue_ms(lambda: gk.gru_scan(xs, mask, *wts, (False, True)), 20),
            "gru_scan_carries": enqueue_ms(lambda: gk.gru_scan_carries(xs, mask, *wts, (False, True)), 20),
            "gru_scan_backward": enqueue_ms(lambda: gk.gru_scan_backward(xs, mask, *wts, (False, True), hs, d_out), 20),
        }

    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels, host = _kernels(torch, prof), _host_ops(torch, prof)
    busy_s = sum(k[0] for k in kernels) / 1e6
    print(card)
    print(json.dumps({
        "card": card, "model": model_name, "batch": batch, "steps": steps, "ms_per_step": step_ms,
        "phases_ms_synchronised": phases, "host_enqueue_ms": enqueue, "torch_sync_points": sync_points,
        "profiled_steps": n_prof, "profiled_ms_per_step": wall_s / n_prof * 1e3,
        "device_busy_ms_per_step": busy_s / n_prof * 1e3, "device_busy_share": busy_s / wall_s,
        "kernel_launches_per_step": sum(k[1] for k in kernels) / n_prof,
    }))
    _print_table(kernels, 25, n_prof)
    _print_table(host, 25, n_prof, "host operator (self CPU time)")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    suffix = "" if model_name == "VQVAE" else "_" + model_name.lower()
    prof.export_chrome_trace(os.path.join(out_dir, f"torch_profile_train{suffix}.json"))


def _profile_supervised(torch, chip_smoke) -> None:
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    card = _card()
    tmp = tempfile.mkdtemp(prefix="torch_profile_supervised_")
    try:
        tables = chip_smoke._public_tables(chip_smoke.PUBLIC_FRAMES)
        root = chip_smoke._write_public_project(os.path.join(tmp, "full"), tables, chip_smoke.PUBLIC_FRAMES)
        coords = chip_smoke._getters_project(root, tables, chip_smoke.PUBLIC_FRAMES, "cuda")
        chip_smoke._supervised(coords)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chip_smoke._supervised(coords)
        timed_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chip_smoke._supervised(coords)
            wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = _kernels(torch, prof)
    host = _host_ops(torch, prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    runtime = {key: count for _, count, key in host if key.startswith("cuda")}
    print(card)
    print(json.dumps({
        "card": card, "frames": 2 * chip_smoke.PUBLIC_FRAMES, "timed_s": timed_s, "profiled_wall_s": wall_s,
        "device_busy_s": busy_s, "device_busy_share": busy_s / wall_s,
        "kernel_launches": sum(r[1] for r in rows), "cuda_runtime_calls": runtime,
    }))
    _print_table(rows, 20)
    _print_table(host, 25, what="host operator")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "torch_profile_supervised.json"))


def _profile_cohort(torch, chip_smoke) -> None:
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    card = _card()
    tmp = tempfile.mkdtemp(prefix="torch_profile_cohort_")
    try:
        lengths = dict(zip(chip_smoke.COHORT_KEYS, chip_smoke.COHORT_FRAMES))
        tables = chip_smoke._public_tables(0, seed=1, lengths=lengths)
        root = chip_smoke._write_public_project(os.path.join(tmp, "cohort"), tables, max(lengths.values()))
        coords = chip_smoke._cohort_project(root, "cuda")
        merged = coords.get_graph_dataset(**chip_smoke.GENERAL)[3]
        kw = {k: v for k, v in chip_smoke.GENERAL.items() if k != "window_size"}

        def scale():
            merged.preprocess(coordinates=coords, window_size=chip_smoke.WINDOW, return_windows=False, **kw)
            torch.cuda.synchronize()

        scale()
        t0 = time.perf_counter()
        scale()
        timed_s = time.perf_counter() - t0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            scale()
            wall_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = _kernels(torch, prof)
    host = _host_ops(torch, prof)
    busy_s = sum(r[0] for r in rows) / 1e6
    runtime = {key: count for _, count, key in host if key.startswith("cuda")}
    frame = next(iter(merged._device_frames.values()))
    print(card)
    print(json.dumps({
        "card": card, "recordings": len(lengths), "frames": list(lengths.values()),
        "columns": int(frame.shape[1]), "scaling": kw, "timed_s": timed_s, "profiled_wall_s": wall_s,
        "device_busy_s": busy_s, "device_busy_share": busy_s / wall_s,
        "kernel_launches": sum(r[1] for r in rows), "cuda_runtime_calls": runtime,
    }))
    _print_table(rows, 20)
    _print_table(host, 25, what="host operator")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "torch_profile_cohort.json"))


def _profile_posthoc(torch, chip_smoke) -> None:
    from torch.profiler import ProfilerActivity, profile

    card = _card()
    n_rec, frames, k, d = chip_smoke.POSTHOC_COHORT
    counts, emb, conds = chip_smoke.synthetic_cohort(n_rec, frames, k, d)
    chip_smoke.lab_cohort_pass(counts, emb, conds, "cuda")
    t0 = time.perf_counter()
    stages, _ = chip_smoke.lab_cohort_pass(counts, emb, conds, "cuda")
    timed_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chip_smoke.lab_cohort_pass(counts, emb, conds, "cuda")
        wall_s = time.perf_counter() - t0
    rows = _kernels(torch, prof)
    host = _host_ops(torch, prof)
    copies = [r for r in rows if r[2].startswith("Memcpy")]
    kernels = [r for r in rows if not r[2].startswith("Memcpy")]
    kernel_s, copy_s = sum(r[0] for r in kernels) / 1e6, sum(r[0] for r in copies) / 1e6
    runtime = {key: count for _, count, key in host if key.startswith("cuda")}
    print(card)
    print(json.dumps({
        "card": card, "recordings": n_rec, "frames": n_rec * frames, "clusters": k, "embedding_dim": d,
        "timed_s": timed_s, "timed_stages_s": stages, "profiled_wall_s": wall_s,
        "kernel_s": kernel_s, "copy_s": copy_s, "device_busy_share": (kernel_s + copy_s) / wall_s,
        "copy_share": copy_s / wall_s, "kernel_launches": sum(r[1] for r in kernels),
        "copies": {key: {"ms": us / 1e3, "count": n} for us, n, key in copies}, "cuda_runtime_calls": runtime,
    }))
    _print_table(rows, 20)
    _print_table(host, 25, what="host operator")
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "torch_profile_posthoc.json"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", help="checkout of the port to profile (default: this one)")
    ap.add_argument("--animals", nargs="+", help="animal ids of the recording (default: chip_smoke.py's two)")
    ap.add_argument("--train", action="store_true", help="profile one train step instead of the path")
    ap.add_argument("--model", default="VQVAE", choices=("VQVAE", "VaDE"), help="--train: the model")
    ap.add_argument("--batch", type=int, default=256, help="--train: windows a step")
    ap.add_argument("--steps", type=int, default=20, help="--train: timed steps")
    ap.add_argument("--supervised", action="store_true",
                    help="profile supervised_annotation on the public project instead of the path")
    ap.add_argument("--cohort", action="store_true",
                    help="profile the general route's scaling pass on chip_smoke.py's cohort instead")
    ap.add_argument("--posthoc", action="store_true",
                    help="profile one post-hoc pass on chip_smoke.py's synthetic lab cohort instead")
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
    if args.train:
        _profile_train(torch, chip_smoke, args.batch, args.steps, args.model)
        return 0
    if args.supervised:
        _profile_supervised(torch, chip_smoke)
        return 0
    if args.cohort:
        _profile_cohort(torch, chip_smoke)
        return 0
    if args.posthoc:
        _profile_posthoc(torch, chip_smoke)
        return 0
    card = _card()
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
