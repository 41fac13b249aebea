"""The JAX package's outputs for the port's TCN / transformer / Contrastive
tests, computed once by ``scripts/make_torch_reference.py`` and read by the
tests from ``tests/data/encoder_cases.npz``.

Compiling these deep models' JAX programs costs 5-15 s each on a CPU (the
16-block TCNs, their gradients), several times that when tier-1 runs them
beside five other test workers, which pushed the suite past its time
limit. So the expensive cases are computed here, with the same draws the
tests make, and stored: the models' eval forwards, one train step of
VQ-VAE-TCN, of VaDE-transformer (main phase) and of Contrastive-TCN,
Contrastive's eval and train forwards at each encoder, and a Contrastive-TCN
served through ``embedding_per_video`` with its "msm" soft counts on the
public fixture (the JAX package's project and graph dataset). Parameters and
batch statistics are not stored: both sides draw them with numpy from the
stored tree layout (``draw_tree``), so the file holds the JAX outputs, the
dropout masks they drew and the layout.

    JAX_PLATFORMS=cpu python scripts/make_torch_reference.py   # writes it with the other references

The file also holds the ``provenance`` digest of what its numbers were made
from: the JAX package's sources, the writer and the helpers it calls, and
the inputs the cases are fed. ``load`` computes it again and fails when it
differs, so that the tests never compare against numbers of other code or
other inputs.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import tempfile

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REFERENCE = os.path.join(TESTS, "data", "encoder_cases.npz")
JAX_PACKAGE = os.path.join(os.path.dirname(TESTS), "deepof_tpu")
# (test module, functions) whose code makes the stored numbers.
WRITER_FUNCTIONS = (
    ("torch_encoder_cases.py", ("draw_tree", "model_inputs", "contrastive_inputs", "_layout", "_flatten", "write")),
    ("test_torch_encoders.py", ("_recording",)),
    ("test_torch_contrastive.py", ("_view_draws_jax", "_shift_draws", "_interp_draws", "_rotate_draws",
                                   "_noise_draws")),
    ("test_torch_public.py", ("write_project", "_project_args", "_recording", "_write_csv")),
)
B, LATENT, K = 8, 4, 4
T_FULL = 16
MODELS = [("VQVAE", "TCN"), ("VQVAE", "transformer"), ("VaDE", "TCN"), ("VaDE", "transformer")]
STEPPED = (("VQVAE", "TCN"), ("VaDE", "transformer"))
CONTRASTIVE_ENCODERS = ("recurrent", "TCN", "transformer")
# embedding_per_video's keywords of the served Contrastive case.
SERVE_KWARGS = dict(n_micro=12, batch_size=64)


def draw_tree(layout, seed, kind):
    """A nested dict of numpy arrays for ``layout`` ([(path, shape)], in the
    order flax's trees flatten), drawn from ``seed``. ``kind`` "params":
    kernels N(0, fan_in^-1/2) (attention q / k / v over their input axis),
    BatchNorm and LayerNorm scales 1 + N(0, 0.1), biases N(0, 0.05), other
    leaves (CensNet, the latent heads) N(0, 0.5), as flax's initialisers
    scale them; "stats": BatchNorm means N(0, 0.2), variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for path, shape in layout:
        names = path.split("/")
        if kind == "stats":
            leaf = rng.normal(scale=0.2, size=shape) if names[-1] == "mean" else rng.uniform(0.5, 1.5, size=shape)
        elif names[-1] == "kernel":
            fan_in = shape[0] if names[-2] in ("query", "key", "value") else int(np.prod(shape[:-1]))
            leaf = rng.normal(scale=fan_in ** -0.5, size=shape)
        elif names[-1] == "scale":
            leaf = 1.0 + rng.normal(scale=0.1, size=shape)
        elif names[-1] == "bias":
            leaf = rng.normal(scale=0.05, size=shape)
        else:
            leaf = rng.normal(scale=0.5, size=shape)
        node = tree
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = leaf.astype(np.float32)
    return tree


def model_inputs(model, encoder):
    """(x, a) windows and the draw seed of one of MODELS."""
    from test_torch_train import _windows

    i = MODELS.index((model, encoder))
    x, a = _windows(np.random.default_rng(10 + i), B)
    return x, a, 20 + i


def contrastive_inputs(seed):
    """(B, T_FULL, N, 3) full windows of a Contrastive case."""
    from test_torch_train import N

    return np.random.default_rng(seed).normal(size=(B, T_FULL, N, 3)).astype(np.float32)


def _flatten(tree, prefix):
    out = {}
    for name, value in tree.items():
        path = f"{prefix}/{name}"
        out.update(_flatten(value, path) if isinstance(value, dict) else {path: np.asarray(value)})
    return out


def _unflatten(arrays, prefix):
    tree = {}
    for name, value in arrays.items():
        if name.startswith(prefix + "/"):
            *parents, leaf = name[len(prefix) + 1:].split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = value
    return tree


def load():
    """{case: {"layout": ..., "stats_layout": ..., name: array or tree}} of
    the reference file: ``params`` / ``stats`` drawn from the layouts (seeds
    ``seed``, ``seed + 1``), each stored tree (``out``, ``grads``, ``moved``,
    ``draws``) nested again, ``masks`` a list."""
    ref = dict(np.load(REFERENCE))
    if str(ref.get("provenance")) != provenance():
        raise AssertionError(f"{REFERENCE} was made from other JAX sources, writer code or inputs than these: "
                             "write it again with scripts/make_torch_reference.py")
    cases = json.loads(str(ref["cases"]))
    out = {}
    for case, meta in cases.items():
        entry = dict(meta)
        entry["params"] = draw_tree(meta["layout"], meta["seed"], "params")
        entry["stats"] = draw_tree(meta["stats_layout"], meta["seed"] + 1, "stats")
        for tree in ("out", "grads", "moved", "draws"):
            entry[tree] = _unflatten(ref, f"{case}/{tree}")
        entry["masks"] = [ref[f"{case}/mask/{i}"] for i in range(meta["n_masks"])]
        out[case] = entry
    return out


def _function_sources(module_file, names):
    """The source text of the top-level functions ``names`` of a tests/
    file, read without importing it."""
    with open(os.path.join(TESTS, module_file)) as f:
        text = f.read()
    found = {node.name: ast.get_source_segment(text, node) for node in ast.parse(text).body
             if isinstance(node, ast.FunctionDef)}
    return [found[name] for name in names]


def provenance():
    """A sha256 hex digest of what the file's numbers come from: every
    source file of the JAX package, the writer's functions and the helpers
    it calls (WRITER_FUNCTIONS), the shapes and settings above, and the
    inputs: each model's windows, the Contrastive windows, the adjacency,
    and the public fixture's csv files as ``write_project`` writes them."""
    from test_torch_public import _project_args, write_project
    from test_torch_train import ADJ, E, N, T

    digest = hashlib.sha256()

    def add(data):
        data = data if isinstance(data, bytes) else str(data).encode()
        digest.update(len(data).to_bytes(8, "little") + data)

    for root, dirs, files in os.walk(JAX_PACKAGE):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for name in sorted(f for f in files if f.endswith(".py")):
            path = os.path.join(root, name)
            add(os.path.relpath(path, JAX_PACKAGE))
            with open(path, "rb") as f:
                add(f.read())
    for module_file, names in WRITER_FUNCTIONS:
        for source in _function_sources(module_file, names):
            add(source)
    add((B, LATENT, K, T_FULL, MODELS, STEPPED, CONTRASTIVE_ENCODERS, sorted(SERVE_KWARGS.items()), N, E, T))
    add(np.ascontiguousarray(ADJ).tobytes())
    for model, encoder in MODELS:
        for array in model_inputs(model, encoder)[:2]:
            add(np.ascontiguousarray(array).tobytes())
    for seed in (6, 10):
        add(contrastive_inputs(seed).tobytes())
    with tempfile.TemporaryDirectory() as tmp:
        root = write_project(tmp, "csv")
        add(sorted((k, v) for k, v in _project_args("", "csv").items() if not k.endswith("path")))
        for name in sorted(os.listdir(os.path.join(root, "Tables"))):
            add(name)
            with open(os.path.join(root, "Tables", name), "rb") as f:
                add(f.read())
    return digest.hexdigest()


# --------------------------------------------------------------------------- #
# The writer (needs the JAX package)
# --------------------------------------------------------------------------- #


def _layout(tree):
    import jax

    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [["/".join(str(getattr(k, "key", k)) for k in path), list(leaf.shape)] for path, leaf in leaves]


def write(path=REFERENCE):
    """Compute every case with the JAX package (each program compiled once,
    all at once in threads) and write the reference file."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    import optax

    from deepof_tpu.models import zoo as jzoo
    from deepof_tpu.train import augment as jaug
    from deepof_tpu.train import config as jconfig
    from deepof_tpu.train import harness as jharness
    from deepof_tpu.train import losses as jlosses
    from test_torch_train import ADJ, E, N, T

    jax.config.update("jax_disable_most_optimizations", True)
    edges = np.stack(np.nonzero(np.triu(ADJ)), axis=1)
    precomp = jaug.build_rotation_precomp(edges, N)
    opt = optax.chain(optax.trace(decay=0.0), optax.scale(0.0))
    cases, calls = {}, {}

    def variables(jm, seed, *args):
        shapes = jax.eval_shape(lambda *a: jm.init(jax.random.PRNGKey(0), *a), *args)
        layout = _layout(shapes["params"])
        stats_layout = _layout(shapes.get("batch_stats", {}))
        return (layout, stats_layout, draw_tree(layout, seed, "params"), draw_tree(stats_layout, seed + 1, "stats"))

    for model, encoder in MODELS:
        x, a, seed = model_inputs(model, encoder)
        jm = jzoo.build_model(model, (T, N, 3), (T, E, 1), ADJ, latent_dim=LATENT, n_components=K,
                              encoder_type=encoder)
        layout, stats_layout, params, stats = variables(jm, seed, jnp.asarray(x), jnp.asarray(a))
        meta = {"layout": layout, "stats_layout": stats_layout, "seed": seed}
        cases[f"eval-{model}-{encoder}"] = dict(meta)
        calls[f"eval-{model}-{encoder}"] = (
            lambda v, xx, aa, jm=jm: jm.apply(v, xx, aa, train=False),
            ({"params": params, "batch_stats": stats}, jnp.asarray(x), jnp.asarray(a)))
        if (model, encoder) in STEPPED:
            key = jax.random.PRNGKey(40)
            if model == "VQVAE":
                step, extra = jharness.make_vqvae_step(jm, opt), ()
            else:
                loss_params = jlosses.vade_params_from_cfg(jconfig.CommonFitCfg(n_components=K), jconfig.VaDECfg(),
                                                           jconfig.TurtleTeacherCfg(), False)
                step = jharness.make_vade_step(jm, opt, loss_params)
                extra = (jnp.float32(0.6), jnp.float32(0.0), jnp.zeros((B, K), jnp.float32), None)
            cases[f"step-{model}-{encoder}"] = dict(meta)
            calls[f"step-{model}-{encoder}"] = (step.__wrapped__, (params, opt.init(params), {"batch_stats": stats},
                                                                   jnp.asarray(x), jnp.asarray(a), key, *extra))

    def contrastive(encoder, seed):
        x = contrastive_inputs(seed)
        jm = jzoo.build_model("Contrastive", (T_FULL, N, 3), (T_FULL, E, 1), ADJ, latent_dim=LATENT,
                              encoder_type=encoder)
        half = jnp.asarray(x[:, :T_FULL // 2])
        return (jm, x, half, jaug.recompute_edges(half, edges)) + variables(jm, seed + 1, half,
                                                                            jaug.recompute_edges(half, edges))

    jm, x, _, _, layout, stats_layout, params, stats = contrastive("TCN", 6)
    step = jharness.make_contrastive_step(jm, opt, jconfig.ContrastiveCfg(), edges, precomp)
    cases["step-Contrastive-TCN"] = {"layout": layout, "stats_layout": stats_layout, "seed": 7, "data_seed": 6}
    calls["step-Contrastive-TCN"] = (step.__wrapped__, (params, opt.init(params), {"batch_stats": stats},
                                                        jnp.asarray(x), jax.random.PRNGKey(7)))
    for encoder in CONTRASTIVE_ENCODERS:
        jm, _, half, a, layout, stats_layout, params, stats = contrastive(encoder, 10)
        cases[f"fwd-Contrastive-{encoder}"] = {"layout": layout, "stats_layout": stats_layout, "seed": 11,
                                               "data_seed": 10}
        calls[f"fwd-Contrastive-{encoder}"] = (
            lambda v, xx, aa, jm=jm: (jm.apply(v, xx, aa), jm.apply(v, xx, aa, train=True, mutable=["batch_stats"],
                                                                    rngs={"dropout": jax.random.PRNGKey(11)})),
            ({"params": params, "batch_stats": stats}, half, a))

    from test_torch_encoders import _recording

    lowered = {name: jax.jit(_recording(fn)).lower(*args) for name, (fn, args) in calls.items()}
    with ThreadPoolExecutor(len(lowered)) as pool:
        compiled = dict(zip(lowered, pool.map(lambda low: low.compile(), lowered.values())))
    arrays = {}
    for name, (_, args) in calls.items():
        result, masks = compiled[name](*args)
        kind = name.split("-")[0]
        if kind == "eval":
            out = {k: v for k, v in result.items() if k not in ("vq_losses", "gmm_params")}
            for k in [k for k in out if hasattr(out[k], "loc")]:
                out[k] = {"loc": out[k].loc, "mask": out[k].mask}
            if "vq_losses" in result:
                out["vq_loss"] = result["vq_losses"]["vq_loss"]
            arrays.update(_flatten(jax.tree_util.tree_map(np.asarray, out), f"{name}/out"))
        elif kind == "step":
            _, state, new_rest, logs = result
            arrays.update(_flatten({k: np.asarray(v) for k, v in logs.items()}, f"{name}/out"))
            arrays.update(_flatten(jax.tree_util.tree_map(np.asarray, state[0].trace), f"{name}/grads"))
            arrays.update(_flatten(jax.tree_util.tree_map(np.asarray, new_rest["batch_stats"]), f"{name}/moved"))
        else:
            want_eval, (want_train, moved) = result
            arrays[f"{name}/out/eval"] = np.asarray(want_eval)
            arrays[f"{name}/out/train"] = np.asarray(want_train)
            arrays.update(_flatten(jax.tree_util.tree_map(np.asarray, moved["batch_stats"]), f"{name}/moved"))
        for i, mask in enumerate(masks):
            arrays[f"{name}/mask/{i}"] = np.asarray(mask)
        cases[name]["n_masks"] = len(masks)
    # The step's own draws from its key: VaDE's two noise draws, the
    # contrastive augmentations.
    rng_model, rng_loss = jax.random.split(jax.random.PRNGKey(40))
    arrays["step-VaDE-transformer/draws/eps_z"] = np.asarray(jax.random.normal(rng_model, (B, LATENT), jnp.float32))
    arrays["step-VaDE-transformer/draws/eps_kl"] = np.asarray(
        jax.random.normal(rng_loss, (32, B, LATENT), jnp.float32))
    from test_torch_contrastive import _view_draws_jax

    rng_aug, _ = jax.random.split(jax.random.PRNGKey(7))
    x = contrastive_inputs(6)
    draws = jax.jit(lambda k: _view_draws_jax(k, x.shape, jconfig.ContrastiveCfg()))(rng_aug)
    arrays.update(_flatten(jax.tree_util.tree_map(np.asarray, draws), "step-Contrastive-TCN/draws"))
    # Contrastive-TCN served with its default "msm" soft counts through the
    # JAX package's embedding_per_video on the public fixture (its device
    # lane, as the port's).
    import tempfile

    from deepof_tpu.data import Project as JaxProject
    from deepof_tpu.train.harness import ModelBundle as JaxBundle
    from deepof_tpu.train.inference import embedding_per_video as jax_embed
    from test_torch_public import _project_args, write_project

    scale = os.environ.get("DEEPOF_TPU_DEVICE_SCALE")
    os.environ["DEEPOF_TPU_DEVICE_SCALE"] = "1"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            root = write_project(tmp, "csv")
            coords = JaxProject(**_project_args(root, "csv")).create(force=True, test=True, verbose=False)
            ggd = coords.get_graph_dataset(window_size=T_FULL)
            n, e = len(ggd[1]["node_columns"]) // 3, len(ggd[1]["edge_columns"])
            jm = jzoo.build_model("Contrastive", (T_FULL, n, 3), (T_FULL, e, 1), np.asarray(ggd[2]),
                                  latent_dim=LATENT, encoder_type="TCN")
            half = T_FULL // 2
            layout, stats_layout, params, stats = variables(jm, 12, jnp.zeros((1, half, n, 3)),
                                                            jnp.zeros((1, half, e, 1)))
            spec = {"model": "Contrastive", "input_shape": [T_FULL, n, 3], "edge_feature_shape": [T_FULL, e, 1],
                    "latent_dim": LATENT, "encoder_type": "TCN", "use_gnn": True}
            bundle = JaxBundle(model=jm, variables={"params": params, "batch_stats": stats}, rebuild_spec=spec)
            emb, counts = jax_embed(coords, ggd[3], bundle, ggd[1], global_scaler=ggd[4], **SERVE_KWARGS)
    finally:
        if scale is None:
            os.environ.pop("DEEPOF_TPU_DEVICE_SCALE")
        else:
            os.environ["DEEPOF_TPU_DEVICE_SCALE"] = scale
    cases["serve-Contrastive-TCN"] = {"layout": layout, "stats_layout": stats_layout, "seed": 12, "n_masks": 0}
    for key in emb.keys():
        arrays[f"serve-Contrastive-TCN/out/embeddings/{key}"] = emb[key].to_numpy()
        arrays[f"serve-Contrastive-TCN/out/soft_counts/{key}"] = counts[key].to_numpy()
    np.savez_compressed(path, cases=json.dumps(cases), provenance=provenance(), **arrays)
    return path
