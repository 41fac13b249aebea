"""Where the GRU layer's backward kernel spends a chunk, on one CUDA GPU.

    python3 scripts/torch_gru_bwd_phases.py [--variants]

``ncu`` does not run on the card's machine, so this script reads the
kernel's own clock: it builds a copy of ``csrc/gru_scan_bwd.cu`` into
``build/cuda_phases/`` in which thread 0 of each CTA reads ``clock64()``
after each barrier of a chunk (phase A1's copies, A2's gate recomputation,
B's serial chain, C1's weight gradients, C2's dx; a barrier is added
between C1 and C2), loads it in place of the kernel's library, and at each
of chip_smoke.py's six training shapes (batch 256: the encoder's node and
edge gru1 / gru2, the decoder's two layers; D = 2, T = 25) prints the card,
the call's ms (CUDA events over 10 calls after 2 warm ones), the cycles a
chunk spends in each phase averaged over the CTAs' chunks, and the launch
plan. The added barrier and counters cost the copy a few percent; the
phases' shares are what it reads. ``--variants`` repeats this for the
kernel's SERIAL_MAX (64, 128) x SMEM_BUDGET (56, 72 KB) constants.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PHASES = ("A1", "A2", "B", "C1", "C2")


def instrument(src: str) -> str:
    """The kernel's source with the phase counters (a __device__ array the
    CTAs add their counts to, and two extern "C" readers)."""
    edits = [
        ("namespace {\n", "__device__ unsigned long long phase_cycles[7];\nnamespace {\n"),
        ("  const int ntiles = (p.B + S - 1) / S;\n",
         "  unsigned long long cyc[5] = {0, 0, 0, 0, 0}, tlast = 0;\n  int nchunk = 0;\n"
         "  const int ntiles = (p.B + S - 1) / S;\n"),
        ("      __syncthreads();  // the last chunk's phase C has read the buffers\n",
         "      __syncthreads();  // the last chunk's phase C has read the buffers\n"
         "      { const unsigned long long c = clock64(); if (nchunk) cyc[4] += c - tlast; tlast = c; ++nchunk; }\n"),
        ('      asm volatile("cp.async.wait_all;\\n" ::: "memory");\n      __syncthreads();\n',
         '      asm volatile("cp.async.wait_all;\\n" ::: "memory");\n      __syncthreads();\n'
         "      { const unsigned long long c = clock64(); cyc[0] += c - tlast; tlast = c; }\n"),
        ("      __syncthreads();\n      // Phase B: the serial chain.\n",
         "      __syncthreads();\n      { const unsigned long long c = clock64(); cyc[1] += c - tlast; tlast = c; }\n"
         "      // Phase B: the serial chain.\n"),
        ("      __syncthreads();\n      // Phase C1:",
         "      __syncthreads();\n      { const unsigned long long c = clock64(); cyc[2] += c - tlast; tlast = c; }\n"
         "      // Phase C1:"),
        ("      // Phase C2: dx",
         "      __syncthreads();\n      { const unsigned long long c = clock64(); cyc[3] += c - tlast; tlast = c; }\n"
         "      // Phase C2: dx"),
        ("  if (kStaged) {\n    __syncthreads();",
         "  __syncthreads();\n  { const unsigned long long c = clock64(); cyc[4] += c - tlast; }\n"
         "  if (tid == 0) {\n    for (int k = 0; k < 5; ++k) atomicAdd(phase_cycles + k, cyc[k]);\n"
         "    atomicAdd(phase_cycles + 5, (unsigned long long)nchunk);\n    atomicAdd(phase_cycles + 6, 1ull);\n  }\n"
         "  if (kStaged) {\n    __syncthreads();"),
    ]
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel's source changed: {old.strip()[:60]!r} is not there once")
        src = src.replace(old, new)
    return src + (
        '\nextern "C" int phase_cycles_read(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, phase_cycles, sizeof(phase_cycles));\n}\n"
        'extern "C" int phase_cycles_reset() {\n  unsigned long long z[7] = {0};\n'
        "  return (int)cudaMemcpyToSymbol(phase_cycles, z, sizeof(z));\n}\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", action="store_true", help="also sweep SERIAL_MAX and SMEM_BUDGET")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_gru_bwd_phases: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepof_tpu_torch.ops import cuda_build
    from deepof_tpu_torch.ops import gru_kernels as gk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    src = instrument(open(os.path.join(cuda_build.CSRC_DIR, "gru_scan_bwd.cu")).read())
    variants = {"kernel": src}
    if args.variants:
        for serial in (64, 128):
            for budget in (56, 72):
                v = re.sub(r"constexpr int SERIAL_MAX = \d+;", f"constexpr int SERIAL_MAX = {serial};", src)
                v = re.sub(r"constexpr int SMEM_BUDGET = \d+ \* 1024;", f"constexpr int SMEM_BUDGET = {budget} * 1024;", v)
                variants[f"SERIAL_MAX {serial}, SMEM_BUDGET {budget} KB"] = v
    out_dir = os.path.join(ROOT, "build", "cuda_phases")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, text) in enumerate(variants.items()):
        path = os.path.join(out_dir, f"v{i}")
        with open(path + ".cu", "w") as fh:
            fh.write(text)
        procs[name] = (path + ".so", subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", path + ".so", path + ".cu"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = so
    cuda_build.build(("gru_scan",))

    for name, so in libs.items():
        lib = cuda_build.use("gru_scan_bwd", so)
        lib.phase_cycles_read.argtypes = [ctypes.c_void_p]
        gk._bwd_plan.cache_clear()
        g = torch.Generator().manual_seed(5)
        for b, f, h, outputs, kind in cs.GRU_TRAIN_SHAPES:
            x, mask, w = cs._gru_train_inputs(torch, g, torch.device("cuda"), b, cs.WINDOW, f, h, 2, kind, full=True)
            _, _, hs = gk.gru_scan_carries(x, mask, *w, (False, True), outputs)
            d_out = torch.randn(b, cs.WINDOW, 2 * h, generator=g).cuda() if outputs else None
            d_fin = torch.randn(b, 2 * h, generator=g).cuda() if kind == "prefix" else None

            def call():
                return gk.gru_scan_backward(x, mask, *w, (False, True), hs, d_out, d_fin)

            ms = cs._cuda_ms(torch, call, reps=10)
            torch.cuda.synchronize()
            lib.phase_cycles_reset()
            call()
            torch.cuda.synchronize()
            counts = (ctypes.c_ulonglong * 7)()
            lib.phase_cycles_read(ctypes.addressof(counts))
            chunks = max(counts[5], 1)
            plan = gk.gru_scan_bwd_config(b, cs.WINDOW, f, h, 2)
            print({"build": name, "shape": f"x ({b}, {cs.WINDOW}, {f}), H {h}", "ms": ms,
                   "cycles_per_chunk": {k: counts[i] / chunks for i, k in enumerate(PHASES)},
                   "chunks": counts[5], "ctas": counts[6],
                   "plan": {k: plan[k] for k in ("streams_per_cta", "steps_per_chunk", "ctas_per_sm", "grid",
                                                 "smem_bytes", "weights")}}, flush=True)
    cuda_build.use("gru_scan_bwd", None)
    gk._bwd_plan.cache_clear()
    return 0


if __name__ == "__main__":
    sys.exit(main())
