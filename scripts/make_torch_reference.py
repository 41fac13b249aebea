"""Write the JAX package's VaDE serving outputs as a small reference file
that the port is held to where JAX is not installed (on the card).

    JAX_PLATFORMS=cpu python scripts/make_torch_reference.py [--out PATH]

Needs both packages (jax, flax, pandas), so it runs on a CPU machine, not on
the card's. It builds chip_smoke.py's cohort project at a small length
(three csv recordings of two deepof_14 animals, 400 / 360 / 320 frames,
seed 1) with the port on the CPU, takes deepof's tutorial graph dataset of
it (animal B aligned on Spine_1: 77 columns, window 25) and the first
recording's scaled frame (320 rows, float32), initialises a VaDE (latent 8,
10 components) with the JAX package's own ``init`` at ``PRNGKey(0)``, and
serves the frame with the JAX package's ``scanned_windowed_forward``. The
file holds the flax parameters (``params/<path>``), the frame, the encoder
layout, the adjacency matrix, and the JAX embeddings, soft counts and hard
labels. ``chip_smoke.py`` (phase 10) and ``tests/test_torch_posthoc.py`` read
it.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "tests", "data", "vade_reference.npz")
LENGTHS = (400, 360, 320)


def _flatten(tree, prefix="params"):
    out = {}
    for name, value in tree.items():
        path = f"{prefix}/{name}"
        out.update(_flatten(value, path) if isinstance(value, dict) else {path: np.asarray(value)})
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=DEFAULT_OUT)
    args = parser.parse_args()
    sys.path.insert(0, REPO)

    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from deepof_tpu.models import zoo as jzoo
    from deepof_tpu.train.harness import ModelBundle as JaxBundle
    from deepof_tpu.train.inference import scanned_windowed_forward as jax_forward
    from deepof_tpu_torch.core.storage import get_dt

    with tempfile.TemporaryDirectory() as tmp:
        tables = cs._public_tables(0, seed=1, lengths=dict(zip(cs.COHORT_KEYS, LENGTHS)))
        root = cs._write_public_project(os.path.join(tmp, "cohort"), tables, max(LENGTHS))
        coords = cs._cohort_project(root, "cpu")
        _, meta, adjacency, tab_dict, _ = coords.get_graph_dataset(**cs.TUTORIAL)
        key = cs.COHORT_KEYS[0]
        frame = np.asarray(get_dt(tab_dict._scaled_frames, key), np.float32)
        columns = list(get_dt(tab_dict._scaled_frames, key, only_metainfo=True)["columns"])
    node = np.asarray([columns.index(c) for c in meta["node_columns"]], np.int64)
    edge = np.asarray([columns.index(c) for c in meta["edge_columns"]], np.int64)
    adjacency = np.asarray(adjacency)
    n, e, window = len(node) // 3, len(edge), cs.WINDOW

    jm = jzoo.build_model("VaDE", (window, n, 3), (window, e, 1), adjacency, latent_dim=cs.LATENT,
                          n_components=cs.N_COMPONENTS)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, window, n, 3)), jnp.zeros((1, window, e, 1)))["params"]
    params = jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), params)
    spec = {"model": "VaDE", "input_shape": [window, n, 3], "edge_feature_shape": [window, e, 1],
            "n_components": cs.N_COMPONENTS, "use_angles": False}
    bundle = JaxBundle(model=jm, variables={"params": jax.tree_util.tree_map(jnp.asarray, params)},
                       rebuild_spec=spec)
    layout = {"node": node.tolist(), "edge": edge.tolist(), "angle": None}
    emb, counts = jax_forward(bundle, frame, layout, window, "VaDE", block=128)
    emb, counts = np.asarray(emb, np.float32), np.asarray(counts, np.float32)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(
        args.out, frame=frame, node=node, edge=edge, adjacency=adjacency, window=window,
        latent=cs.LATENT, n_components=cs.N_COMPONENTS, embeddings=emb, soft_counts=counts,
        hard_labels=counts.argmax(axis=1), **_flatten(params),
    )
    print(f"{args.out}: frame {frame.shape}, embeddings {emb.shape}, soft counts {counts.shape}, "
          f"{os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
