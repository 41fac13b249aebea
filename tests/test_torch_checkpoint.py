"""The port's epoch checkpoints and resumed fits, and the best-score model
of a VaDE distilled from the TURTLE teacher, on the CPU.

The JAX package saves its train state through Orbax (``TrainCheckpointer``,
``maybe_resume``) and the port writes ``torch.save`` files, so the two are
held to the same rules rather than to the same files: which epochs are
saved (``checkpoint_every``) and kept (``max_to_keep``), the start epoch of
a resumed call (the saved epoch + 1) and its schedule iteration
(``start_epoch * n_batches``, the JAX package's ``fit_vade``). A restored
state must equal the saved one bit for bit: the model's parameters and
buffers (the TCN's BatchNorm statistics), the optimiser's moments, steps
and update count. An Orbax directory raises. The data are
``tests/test_checkpoint.py``'s: 48 + 16 random windows of 8 frames, 6
nodes and 7 edges.
"""

import copy
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deepof_tpu.train import checkpoint as jcheckpoint
from deepof_tpu.train import schedules as jschedules

from deepof_tpu_torch.train import checkpoint as pcheckpoint
from deepof_tpu_torch.train import harness as pharness
from deepof_tpu_torch.train import teacher as pteacher
from deepof_tpu_torch.train.inference import ModelBundle

from test_torch_encoders import one_torch_thread  # noqa: F401 (an autouse fixture of this module too)

N, E, W = 6, 7, 8
EDGES = [(0, 1), (0, 2), (1, 2), (2, 3), (3, 4), (3, 5), (4, 5)]
ADJ = np.zeros((N, N), np.float32)
for _i, _j in EDGES:
    ADJ[_i, _j] = ADJ[_j, _i] = 1.0
BATCH, LIMIT = 16, 2  # 3 batches an epoch, 2 of them trained
TEACHER = dict(teacher_outer_steps=4, teacher_inner_steps=2, teacher_batch_size=32)


def _dataset(seed=0):
    rng = np.random.default_rng(seed)

    def part(n):
        return (rng.normal(size=(n, W, 3 * N)).astype(np.float32), rng.normal(size=(n, W, E)).astype(np.float32),
                np.zeros((n, W, 0), np.float32))

    return ({"v1": part(48)}, {"v2": part(16)}), {}, ADJ


def _fit(model_name, epochs, **kw):
    args = dict(adjacency_matrix=ADJ, model_name=model_name, batch_size=BATCH, latent_dim=4, n_clusters=3,
                epochs=epochs, save_weights=False, verbose=False, limit_train_batches=LIMIT,
                limit_val_batches=1, device="cpu")
    if model_name == "VaDE":
        args["pretrain_epochs"] = 1
    if model_name == "Contrastive":
        args["encoder_type"] = "TCN"  # BatchNorm running statistics in the state
    return pharness.train_deepof_model(_dataset(), **{**args, **kw})


def _assert_equal_states(got, want, where=""):
    """Nested dicts / lists of tensors and numbers, equal bit for bit."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_equal_states(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_states(g, w, f"{where}/{i}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want.cpu()), where
    else:
        assert got == want, where


def test_checkpointer_rules_match_orbax_and_orbax_raises(tmp_path):
    """Save interval, force, max_to_keep and the start epoch against the
    JAX package's Orbax checkpointer; the port refuses its directory."""
    state = {"params": {"w": jnp.zeros(2)}, "epoch": 0}
    tensor_state = {"model": {"w": torch.arange(6.0).reshape(2, 3)}, "optimizer": {"updates": 4, "betas": (0.9, 0.99)}}
    saved = {}
    with jcheckpoint.TrainCheckpointer(str(tmp_path / "orbax"), max_to_keep=2, save_interval_epochs=2) as jck, \
            pcheckpoint.TrainCheckpointer(str(tmp_path / "port"), max_to_keep=2, save_interval_epochs=2) as pck:
        for epoch, force in ((0, False), (1, False), (2, False), (3, False), (4, True), (5, False), (6, False)):
            st = {**tensor_state, "epoch": epoch, "model": {"w": tensor_state["model"]["w"] + epoch}}
            assert pck.save(epoch, st, force=force) == jck.save(epoch, {**state, "epoch": epoch}, force=force)
            saved[epoch] = st
        assert pck.latest_epoch() == jck.latest_epoch() == 5
    orbax_steps = sorted(int(d) for d in os.listdir(tmp_path / "orbax") if d.isdigit())
    assert pck.epochs() == orbax_steps == [4, 5]
    assert sorted(os.listdir(tmp_path / "port")) == ["epoch_4.pt", "epoch_5.pt"]
    for epoch in (4, 5):
        _assert_equal_states(pck.restore(epoch), saved[epoch])
    jck = jcheckpoint.TrainCheckpointer(str(tmp_path / "orbax"))
    start, restored = pcheckpoint.maybe_resume(pck)
    assert start == jcheckpoint.maybe_resume(jck, state)[0] == 6
    jck.close()
    _assert_equal_states(restored, {k: v for k, v in saved[5].items() if k != "epoch"})
    assert pcheckpoint.maybe_resume(None) == (0, None)
    assert pcheckpoint.maybe_resume(pcheckpoint.TrainCheckpointer(str(tmp_path / "empty"))) == (0, None)
    with pytest.raises(FileNotFoundError):
        pcheckpoint.TrainCheckpointer(str(tmp_path / "empty")).restore()
    with pytest.raises(TypeError, match="Orbax"):
        pcheckpoint.TrainCheckpointer(str(tmp_path / "orbax"))
    with pytest.raises(TypeError, match="Orbax"):
        pharness.train_deepof_model(_dataset(), ADJ, model_name="VQVAE", checkpoint_dir=str(tmp_path / "orbax"),
                                    device="cpu")


@pytest.mark.parametrize("model_name", ["VQVAE", "VaDE", "Contrastive"])
def test_fit_saves_restores_and_resumes(tmp_path, model_name):
    """Three epochs saved every epoch (the newest 3 kept) hold the state the
    fit saved, bit for bit; a call for 5 epochs resumes at epoch 3; a call
    for 5 again runs none and returns the saved state; at checkpoint_every 2
    only epoch 1 of 3 is saved."""
    ck = str(tmp_path / "ck")
    seen = {}
    original = pcheckpoint.TrainCheckpointer.save

    def save(self, epoch, state, force=False):
        seen[epoch] = copy.deepcopy(state)
        return original(self, epoch, state, force)

    with mock.patch.object(pcheckpoint.TrainCheckpointer, "save", save):
        _fit(model_name, 3, checkpoint_dir=ck)
    expected = ["epoch_0.pt", "epoch_1.pt", "epoch_2.pt"] + (["teacher_init.pkl"] if model_name == "VaDE" else [])
    assert sorted(os.listdir(ck)) == expected and sorted(seen) == [0, 1, 2]
    checkpointer = pcheckpoint.TrainCheckpointer(ck)
    for epoch, state in seen.items():
        assert state["epoch"] == epoch
        _assert_equal_states(checkpointer.restore(epoch), state)
    last = seen[2]
    assert last["optimizer"]["updates"] == 3 * LIMIT
    if model_name == "Contrastive":
        assert any("running_mean" in k for k in last["model"])

    bundle, *_ = _fit(model_name, 5, checkpoint_dir=ck)
    losses = [k for k in bundle.history if k.endswith("total_loss") and not k.startswith("pretrain/")]
    assert losses and all(len(bundle.history[k]) == 2 for k in losses)
    assert checkpointer.epochs() == [2, 3, 4]
    if model_name == "VaDE":
        # The main phase's KL weights restart at iteration start_epoch *
        # n_batches (3 * 3), not at the 3 * LIMIT batches trained, and go on
        # a batch at a time.
        sched = jschedules.WeightSchedule(n_batches_per_epoch=3, mode="linear", warmup_epochs=15,
                                          max_weight=1.0, cooldown_epochs=5, end_weight=0.2)
        want = [np.mean([sched.weight_at(3 * 3 + LIMIT * i + b) for b in range(LIMIT)]) for i in (0, 1)]
        np.testing.assert_allclose(bundle.history["kl_weight"], want, rtol=1e-6)

    bundle, *_ = _fit(model_name, 5, checkpoint_dir=ck)
    assert not [k for k in bundle.history if not k.startswith("pretrain/")]
    _assert_equal_states(bundle.model.state_dict(), pcheckpoint.TrainCheckpointer(ck).restore(4)["model"])

    ck2 = str(tmp_path / "every2")
    _fit(model_name, 3, checkpoint_dir=ck2, checkpoint_every=2)
    assert pcheckpoint.TrainCheckpointer(ck2).epochs() == [1]
    if model_name == "VaDE":
        snapshot = torch.load(os.path.join(ck, "teacher_init.pkl"), weights_only=True)
        assert set(snapshot["model"]) == set(bundle.model.state_dict())


def test_optimizer_state_keeps_its_schedules():
    """VaDE's grouped main optimiser: a loaded state takes the saved moments
    and update count and keeps the optimiser's own lr schedules."""
    params = {name: torch.nn.Parameter(torch.randn(3)) for name in ("encoder.w", "decoder.w", "latent_space.gmm_means")}
    opt = pharness._make_vade_main_optimizer(params.items(), 1e-2, 3e-2, 2, 1, 2)
    for _ in range(3):
        for p in params.values():
            p.grad = torch.randn(3)
        opt.step()
    state = opt.state_dict()
    assert state["updates"] == 3 and all("schedule" not in g for g in state["param_groups"])
    fresh = pharness._make_vade_main_optimizer(params.items(), 1e-2, 3e-2, 2, 1, 2)
    fresh.load_state_dict(torch.load(_save(state), weights_only=True))
    assert fresh.updates == 3 and all("schedule" in g for g in fresh.param_groups)
    _assert_equal_states(fresh.state_dict(), state)
    for o in (opt, fresh):
        for p in params.values():
            p.grad = torch.ones(3)
        o.step()
    assert [g["lr"] for g in fresh.param_groups] == [g["lr"] for g in opt.param_groups]


def _save(obj):
    import io

    buf = io.BytesIO()
    torch.save(obj, buf)
    buf.seek(0)
    return buf


def test_best_score_bundle_and_teacher_refreshes(tmp_path):
    """A distilled VaDE of 5 epochs returns its best-score bundle and saves
    it as ``_best_score.ckpt``; the teacher refits every 2 epochs up to
    ``teacher_freeze_at`` and re-initialises the prior each time."""
    calls = {"fit": 0, "init": 0}
    fit, init = pteacher.fit_turtle_teacher, pteacher.initialize_gmm_from_teacher

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    with mock.patch.object(pharness, "fit_turtle_teacher", counted("fit", fit)), \
            mock.patch.object(pharness, "initialize_gmm_from_teacher", counted("init", init)):
        bundle, score, _, summary = _fit(
            "VaDE", 5, use_turtle_teacher=True, teacher_refresh_every=2, reinit_gmm_on_refresh=True,
            teacher_freeze_at=None, save_weights=True, output_path=str(tmp_path), **TEACHER)
        assert calls == {"fit": 3, "init": 3}  # the first fit, then after epochs 2 and 4
        _fit("VaDE", 5, use_turtle_teacher=True, teacher_refresh_every=2, **TEACHER)
        assert calls == {"fit": 6, "init": 4}  # teacher_freeze_at 10 ends nothing; no re-init
        _fit("VaDE", 5, use_turtle_teacher=True, teacher_refresh_every=1, teacher_freeze_at=2, **TEACHER)
        assert calls == {"fit": 8, "init": 5}  # a refresh after epoch 2 only (epoch 1 never refreshes)

    scores = bundle.history["val_alignment_score"]
    assert len(scores) == 5 and all(0.0 <= s <= 1.0 for s in scores)
    assert summary["distill_loss"] > 0
    assert score is not None and score.best_score == bundle.best_score and 0.0 <= score.best_score <= 1.0
    assert score.best_score == scores[4]  # the rule's first epoch: more than max(3, ceil(0.5))
    models = os.path.join(tmp_path, "models")
    name = "VaDE_recurrent_latent4_k3_run0"
    assert sorted(os.listdir(models)) == [f"{name}.ckpt", f"{name}_best.ckpt", f"{name}_best_score.ckpt"]
    loaded = ModelBundle.load(os.path.join(models, f"{name}_best_score.ckpt"), device="cpu")
    _assert_equal_states(loaded.model.state_dict(), bundle.best_score_state)
    x, a, _, _ = next(pharness._dataset_from_preprocessed(_dataset()[0][1]).batches(5, shuffle=False))
    torch.testing.assert_close(loaded.group(x, a), score.group(x, a), rtol=0, atol=0)
    np.testing.assert_allclose(score.group(x, a).sum(1).numpy(), 1.0, atol=1e-6)
    # Without validation data no score is tracked.
    (train, _), meta, adj = _dataset()
    _, none, _, _ = pharness.train_deepof_model(
        ((train, {}), meta, adj), adjacency_matrix=ADJ, batch_size=BATCH, latent_dim=4, n_clusters=3, epochs=5,
        pretrain_epochs=0, save_weights=False, verbose=False, limit_train_batches=1, device="cpu",
        use_turtle_teacher=True, **TEACHER)
    assert none is None
