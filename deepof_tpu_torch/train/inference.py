"""Embeddings and soft counts for every stride-1 window of every recording
(port of deepof_tpu/train/inference.py:204 ``scanned_windowed_forward`` and
:287 ``embedding_per_video``, with each model's outputs as
``_model_forward_fn`` :96-110 picks them: the VQ-VAE's encoder output and
soft counts, VaDE's latent (z_mean) and categorical posterior, the
Contrastive encoder's embedding of half windows, T_train // 2 frames).
Soft counts come from the model's head, or from the embeddings through the
gated GMM, the gated MSM + PCCA+, the Gaussian HMM or "combined"
(``gating.py``, ``msm.py``) when ``softcounts_extraction_method`` names one;
a Contrastive model has no head and takes "msm" by default.

Windows never exist on the host: the scaled (T, F) frame is on the device,
and for each block of ``block`` windows one launch of the window kernel
writes the encoder's node, edge and (with the angle stream) angle streams
straight from the frame's rows, which ``forward_streams`` runs through the
encoder, of any kind, in eval mode.

The JAX version rounds the number of blocks up to a power of two so that
recordings of other lengths reuse one compiled program; PyTorch runs
eagerly, so this port runs exactly ceil(n_windows / block) blocks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import warnings

import numpy as np
import torch

from deepof_tpu_torch import gating
from deepof_tpu_torch.core.storage import get_dt
from deepof_tpu_torch.core.table_dict import TableDict
from deepof_tpu_torch.device import fetch_together, resolve_device, to_device
from deepof_tpu_torch.models.blocks import run_mode
from deepof_tpu_torch.models.zoo import SERVING_KEYS
from deepof_tpu_torch.msm import get_soft_counts_hmm
from deepof_tpu_torch.ops.window_kernels import window_streams
from deepof_tpu_torch.train.harness import ModelBundle

__all__ = ["ModelBundle", "embedding_per_video", "scanned_windowed_forward", "stream_tables"]

EXTRACTION_METHODS = ("gmm", "msm", "hmm", "combined")


def _extract_pair_to_gate_key(coordinates, extract_pair: Optional[list]):
    """The gate key of the soft-counts dict an ``extract_pair`` selects."""
    animal_ids = list(coordinates._animal_ids or [""])
    if extract_pair is None:
        if len(animal_ids) <= 1:
            return ""
        return tuple(sorted(animal_ids[:2]))
    if extract_pair == [""]:
        return ""
    if not isinstance(extract_pair, (list, tuple)) or len(extract_pair) != 2:
        raise AssertionError('extract_pair must be a two-id list, or [""] for single-animal')
    a, b = extract_pair
    if a not in animal_ids or b not in animal_ids:
        raise AssertionError(f"Animal IDs {a}, {b} not in {animal_ids}")
    return tuple(sorted([a, b]))


def stream_tables(layout: Dict, use_gnn: bool = True):
    """The window kernel's column tables for the encoder's streams: node n's
    (x, y, speed) columns (N, 3) and edge e's column (E, 1); without the GNN
    the one flat stream's columns (1, 3N), node-major as
    ``x.reshape(b, t, n * 3)`` orders them; then, where ``layout["angle"]``
    is set, the one flat angle stream's columns (1, A)."""
    node = np.asarray(layout["node"], np.int32).reshape(3, -1).T
    tables = [node, np.asarray(layout["edge"], np.int32)[:, None]] if use_gnn else [node.reshape(1, -1)]
    if layout.get("angle") is not None:
        tables.append(np.asarray(layout["angle"], np.int32)[None, :])
    return tables


def scanned_windowed_forward(
    bundle: ModelBundle,
    feats,
    layout: Dict,
    window: int,
    model_name: str,
    block: int = 1024,
    device="cuda",
    fetch: bool = True,
):
    """Embeddings + soft counts for all stride-1 windows of one recording.

    Args:
        bundle: the model (on ``device``) and its rebuild spec.
        feats: (T, F) scaled per-frame features, numpy or tensor.
        layout: {"node": idx, "edge": idx, "angle": idx-or-None} column
            indices into F; node indices in x-block, y-block, speed-block
            order.
        window: the window the model encodes (a Contrastive model's half
            window).
        model_name: "VQVAE", "VaDE" or "Contrastive".
        block: windows per encoder call (compute / memory granularity).
        fetch: False leaves the results on the device.

    Returns:
        (embeddings (W, D), soft_counts (W, K) or None for a Contrastive
        model) float32, numpy (or tensors on the device without
        ``fetch``), W = T - window + 1.
    """
    if model_name not in SERVING_KEYS:
        raise ValueError(f"Unknown model: {model_name}")
    emb_key, sc_key = SERVING_KEYS[model_name]
    dev = resolve_device(device)
    model = bundle.model
    for p in model.parameters():
        if p.device != dev:
            raise ValueError(f"model parameters are on {p.device}, not on {dev}")

    feats = to_device(feats, dev, torch.float32)
    t, f = feats.shape
    n_windows = t - window + 1
    if n_windows <= 0:
        empty = feats.new_zeros((0, 1))
        return (empty.cpu().numpy() if fetch else empty), None
    block = min(block, max(64, 1 << (n_windows - 1).bit_length()))
    n_blocks = -(-n_windows // block)
    rows_per_block = block + window - 1
    padded = feats.new_zeros((n_blocks * block + window - 1, f))
    padded[:t] = feats

    use_gnn = model.encoder.use_gnn
    tables = stream_tables(layout, use_gnn)
    zeros = feats.new_zeros(f)
    ones = feats.new_ones(f)

    embs, scs = [], []
    with run_mode(model, False), torch.inference_mode():
        for i in range(n_blocks):
            rows = padded[i * block:i * block + rows_per_block]
            # (block*N, W, 3), (block*E, W, 1) [and (block, W, A)], from one launch.
            streams = window_streams(rows, tables, zeros, ones, window)
            xg, ag = (streams[0], streams[1]) if use_gnn else (streams[0], None)
            ang = streams[len(tables) - 1] if layout.get("angle") is not None else None
            out = model.forward_streams(xg, ag, ang)
            embs.append(out[emb_key])
            if sc_key is not None:
                scs.append(out[sc_key])
    embs = torch.cat(embs)[:n_windows]
    scs = torch.cat(scs)[:n_windows] if scs else None
    if not fetch:
        return embs, scs
    return embs.cpu().numpy(), None if scs is None else scs.cpu().numpy()


def embedding_per_video(
    coordinates,
    to_preprocess: TableDict,
    model: ModelBundle,
    meta_info: Dict,
    supervised_annotations=None,
    scale: str = "standard",
    animal_id: Optional[str] = None,
    global_scaler: Any = None,
    softcounts_extraction_method: Optional[str] = None,
    n_components: Optional[int] = None,
    samples_max: int = 227272,
    batch_size: int = 256,
    extract_pair: Optional[list] = None,
    embedding_gates: Any = "Center",
    states_per_gate: Optional[int] = None,
    M_gates: int = 3,
    quality_threshold: float = 0.75,
    frac_bps_below: float = 0.5,
    n_micro: int = 200,
    lagtime: int = 3,
    device=None,
):
    """Embeddings and soft counts of every experiment.

    Args:
        coordinates: the project's Coordinates.
        to_preprocess: the merged TableDict that ``get_graph_dataset``
            returns (its fourth item), from either of its lanes: each
            recording's scaled frame is read on the device.
        model: a ModelBundle whose ``rebuild_spec`` names the model, its
            input shape and ``use_angles``: one that ``train_deepof_model``
            returned, one ``ModelBundle.load`` read, or one built by hand.
        meta_info: the graph dataset's metainfo (standardize modes and the
            node / edge / angle columns).
        global_scaler: the scaler fitted at training time. When it is the
            very object ``get_graph_dataset`` fitted (and the settings
            match), its scaled frames are reused; otherwise the merged
            frames are scaled again with it.
        batch_size: windows per encoder call.
        softcounts_extraction_method: None (the model's head) | "gmm" |
            "msm" | "hmm" | "combined". "gmm" and "msm" run the gated
            decoders (per animal pair's distance gate on a multi-animal
            project), "combined" the MSM decoder with the tracking-chaos
            gates of ``quality_threshold`` / ``frac_bps_below`` overlaid,
            "hmm" a Gaussian HMM of ``n_components`` states. A
            Contrastive model, which has no head, takes "msm" by default.
        n_components: states or clusters a gate (default: the model's).
        extract_pair: which animal pair's gate to return (default: the
            first two animal ids, or the "" gate of a single animal).
        embedding_gates / states_per_gate / M_gates / n_micro / lagtime:
            the gate configuration of ``gating.py``.
        device: defaults to the project's.

    Returns:
        (embeddings, soft_counts): TableDicts of (W, D) and (W, K) float32
        arrays per experiment.
    """
    model_name = model.rebuild_spec["model"]
    if model_name not in SERVING_KEYS:
        raise ValueError(f"Unknown model: {model_name}")
    dev = resolve_device(coordinates._device if device is None else device)
    window_size = model.rebuild_spec["input_shape"][0]
    if model_name == "Contrastive":
        # The contrastive encoder reads half windows, each whole.
        window_size //= 2
        softcounts_extraction_method = softcounts_extraction_method or "msm"
    sig = (
        scale,
        meta_info.get("dist_standardize", "per_column"),
        meta_info.get("speed_standardize", "per_column"),
        meta_info.get("coord_standardize", "per_column"),
        samples_max,
    )
    if (
        getattr(to_preprocess, "_scaled_sig", None) == sig
        and to_preprocess._scaled_scaler is global_scaler
    ):
        scaled_tables = to_preprocess._scaled_frames
        device_tables = to_preprocess._scaled_device
    else:
        processed, _, _ = to_preprocess.preprocess(
            coordinates=coordinates, scale=scale, window_size=window_size, window_step=1,
            shuffle=False, samples_max=samples_max, pretrained_scaler=global_scaler,
            dist_standardize=sig[1], speed_standardize=sig[2], coord_standardize=sig[3],
            return_windows=False, test_videos=0,
        )
        scaled_tables = processed[0]
        device_tables = scaled_tables._device_frames

    use_angles = bool(model.rebuild_spec.get("use_angles"))
    pending = {}
    for key in to_preprocess.keys():
        if key not in scaled_tables.keys():
            continue  # all-NaN tables are dropped by preprocess
        if key not in device_tables:
            raise ValueError(f"recording {key!r} has no scaled frame on the device to embed")
        all_cols = list(get_dt(scaled_tables, key, only_metainfo=True)["columns"])
        node_cols = meta_info.get("node_columns")
        if node_cols is not None:
            layout = {
                "node": [all_cols.index(c) for c in node_cols],
                "edge": [all_cols.index(c) for c in meta_info.get("edge_columns")],
                "angle": (
                    [all_cols.index(c) for c in meta_info.get("angle_columns")]
                    if use_angles else None
                ),
            }
        else:
            n_nodes = model.rebuild_spec["input_shape"][1]
            layout = {
                "node": list(range(3 * n_nodes)),
                "edge": list(range(3 * n_nodes, len(all_cols))),
                "angle": None,
            }
        pending[key] = scanned_windowed_forward(
            model, device_tables[key], layout, window_size, model_name,
            block=batch_size, device=dev, fetch=False,
        )

    # Every recording ran back to back on the device; one copy fetches all.
    host = iter(fetch_together([x for pair in pending.values() for x in pair if x is not None]))
    embeddings, soft_counts = {}, {}
    for key, (_, sc) in pending.items():
        embeddings[key] = next(host)
        if sc is not None:
            soft_counts[key] = next(host)

    if not soft_counts or softcounts_extraction_method in EXTRACTION_METHODS:
        k = n_components or (model.rebuild_spec.get("n_components") or 10)
        soft_counts = _extract_soft_counts(
            coordinates, embeddings, softcounts_extraction_method or "gmm", k, states_per_gate or k, window_size,
            supervised_annotations, extract_pair, embedding_gates, M_gates, quality_threshold, frac_bps_below,
            n_micro, lagtime, dev)

    header = dict(
        table_path=coordinates._table_path, animal_ids=coordinates._animal_ids,
        exp_conditions=coordinates._exp_conditions,
    )
    return (TableDict(embeddings, typ="unsupervised_embedding", **header),
            TableDict(soft_counts, typ="unsupervised_counts", **header))


def _extract_soft_counts(coordinates, embeddings, method, k, k_gate, window_size, supervised_annotations,
                         extract_pair, embedding_gates, M_gates, quality_threshold, frac_bps_below, n_micro,
                         lagtime, dev) -> Dict[str, np.ndarray]:
    """Soft counts from the embeddings (deepof_tpu/train/inference.py:464-530)."""
    if method == "hmm":
        return get_soft_counts_hmm(embeddings, n_states=k, device=dev)
    gate_key = _extract_pair_to_gate_key(coordinates, extract_pair)
    common = dict(coordinates=coordinates, embeddings=embeddings, animal_ids=None, window_size=window_size,
                  supervised_annotations=supervised_annotations, embedding_gates=embedding_gates,
                  N_clusters_per_gate=k_gate, M_gates=M_gates, device=dev)
    if method == "gmm":
        counts = gating.get_contrastive_soft_counts_gmm(**common)
    else:  # "msm" / "combined"
        counts = gating.get_contrastive_soft_counts_msm_pcca(n_micro=n_micro, lagtime=lagtime,
                                                             temporal_smooth_win=1, **common)
        if method == "combined":
            chaos = gating.get_supervised_chaos(coordinates, quality_threshold, frac_bps_below, device=dev)
            chaos_counts = gating.get_contrastive_soft_counts_gmm(
                **{**common, "supervised_annotations": chaos, "embedding_gates": ["anychaos"]},
                temporal_smooth_win=1)
            counts = gating.add_chaos_gates(coordinates, counts, chaos_counts, chaos, window_size)
    if gate_key not in counts:
        # Behaviour-gated runs key on behaviour names, and sorted pair keys
        # may not match the project's id order.
        fallback = list(counts.keys())[0]
        warnings.warn(
            f"Requested gate {gate_key!r} not found among {sorted(map(str, counts.keys()))}; returning soft "
            f"counts for gate {fallback!r}. Pass extract_pair (or check embedding_gates) to select a specific "
            "gate.")
        gate_key = fallback
    return {key: np.asarray(c) for key, c in counts[gate_key].items()}
