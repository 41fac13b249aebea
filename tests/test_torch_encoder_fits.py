"""The public entry points with the TCN and transformer encoders and with
Contrastive, on the CPU: ``Coordinates.deep_unsupervised_embedding`` on the
public fixture (two recordings of 300 frames, one held out) for one epoch
of 1 + 1 batches, its history, its checkpoint with the BatchNorm running
statistics, read back by ``ModelBundle.load`` in eval mode and served by
``embedding_per_video`` as the trained bundle serves. The models' numerics
against the JAX package are held in ``test_torch_encoders`` and
``test_torch_contrastive``; this file needs no JAX.
"""

import os

import numpy as np
import pytest
import torch

from deepof_tpu_torch.data import Project
from deepof_tpu_torch.train.inference import embedding_per_video

from test_torch_public import _project_args, write_project

WINDOW, LATENT, K = 8, 4, 4

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's small CPU tensors on one thread: intra-op threads buy
    little at these sizes, and beside tier-1's other test workers they spin
    (these fits took 785 s there on eight threads, ~10 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

VQVAE_KEYS = {"total_loss", "enc_rec_loss", "reconstruct_loss", "vq_loss", "kmeans_loss"}


@pytest.fixture(scope="module")
def public(tmp_path_factory):
    root = write_project(tmp_path_factory.mktemp("encoder_fits"), "csv")
    coords = Project(**_project_args(root, "csv"), device="cpu").create(force=True, test=True, verbose=False)
    return coords, coords.get_graph_dataset(window_size=WINDOW, test_videos=1)


@pytest.mark.parametrize("model,encoder", [("VQVAE", "TCN"), ("VaDE", "transformer"), ("Contrastive", "TCN")])
def test_deep_unsupervised_embedding_trains_saves_and_serves(public, model, encoder):
    """One epoch (VaDE: one pretrain epoch too) with the encoder: the JAX
    package's history keys (Contrastive's without validation), finite
    losses, the checkpoint named as the JAX package names it, its state
    with the running statistics (and the best-validation twin's), read
    back in eval mode serving equal embeddings and soft counts (a
    Contrastive model's half windows and msm counts)."""
    coords, ggd = public
    dataset, meta, adj, tab_dict, scaler = ggd
    kw = dict(contrastive_loss_function="dcl", aug_p_rot=0.5) if model == "Contrastive" else {}
    bundle, score, part, summary = coords.deep_unsupervised_embedding(
        ggd[:3], adjacency_matrix=adj, embedding_model=model, encoder_type=encoder, batch_size=16,
        latent_dim=LATENT, n_clusters=K, epochs=1, pretrain_epochs=1, save_checkpoints=True, verbose=False,
        limit_train_batches=1, limit_val_batches=1, **kw)
    assert (score, part) == (None, None) and summary and all(np.isfinite(v) for v in summary.values())
    if model == "VQVAE":
        assert set(summary) == VQVAE_KEYS | {f"val_{k}" for k in VQVAE_KEYS - {"enc_rec_loss", "vq_loss",
                                                                               "kmeans_loss"}}
    elif model == "Contrastive":
        assert set(summary) == {"total_loss", "pos_similarity", "neg_similarity"}
        assert "n_components" not in bundle.rebuild_spec
    else:
        assert {"pretrain/total_loss", "total_loss", "val_total_loss"} <= set(summary)
    assert not bundle.model.training and bundle.rebuild_spec["encoder_type"] == encoder
    assert any("running_var" in k for k in bundle.model.state_dict())
    if model != "Contrastive":
        assert any("running_var" in k for k in bundle.best_state)
    name = f"{model}_{encoder}_latent{LATENT}_k{K}_run0.ckpt"
    assert os.path.exists(os.path.join(coords._project_path, coords._project_name, "Trained_models", "models",
                                       name))
    loaded, *_ = coords.deep_unsupervised_embedding(None, pretrained=name)
    assert not loaded.model.training
    state = loaded.model.state_dict()
    for k, v in bundle.model.state_dict().items():
        assert torch.equal(state[k], v), k
    extra = {"n_micro": 12} if model == "Contrastive" else {}
    outs = [embedding_per_video(coords, tab_dict, b, meta, global_scaler=scaler, batch_size=64, **extra)
            for b in (bundle, loaded)]
    window = WINDOW // 2 if model == "Contrastive" else WINDOW
    for key in ("test", "test2"):
        assert outs[0][0][key].shape == (300 - window + 1, LATENT)
        if model != "Contrastive":
            assert outs[0][1][key].shape == (300 - window + 1, K)
        np.testing.assert_allclose(outs[0][1][key].sum(axis=1), 1.0, atol=1e-5)
        np.testing.assert_array_equal(outs[1][0][key], outs[0][0][key])
        np.testing.assert_array_equal(outs[1][1][key], outs[0][1][key])
