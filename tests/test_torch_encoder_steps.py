"""One train step of the TCN and transformer models against the JAX
package's, float32 on the CPU: the VQ-VAE with the TCN encoder and decoder
(its decoder twice a step) and VaDE with the transformer encoder and
decoder in its main phase (the JAX package's dropout masks and noise draws
given to the port): every loss, every parameter gradient and the running
statistics after the step. The JAX package's steps (5-15 s of compile
each) were run once by ``scripts/make_torch_reference.py`` on the draws of
``test_torch_encoders`` and are read from ``tests/data/encoder_cases.npz``
(``torch_encoder_cases``); their gradients are those the steps applied,
read from an ``optax.trace`` at decay 0 moved by scale 0.
"""

import shutil

import numpy as np
import pytest
import torch

from deepof_tpu_torch.models.blocks import DropoutDraws, use_dropout_draws
from deepof_tpu_torch.train import config as pconfig
from deepof_tpu_torch.train import harness as pharness
from deepof_tpu_torch.train import losses as plosses

import torch_encoder_cases
from test_torch_encoders import (  # noqa: F401 (one_torch_thread: an autouse fixture of this module too)
    carried,
    one_torch_thread,
    param_grads_close,
    running_stats_close,
)
from test_torch_train import GRAD_RTOL, _close
from torch_encoder_cases import K

# The VQ-VAE-TCN step's gradients: 16 encoder and 4 decoder TemporalBlocks
# (the decoder run twice) carry float32 rounding that GRAD_RTOL cannot hold
# between two float32 implementations: against the port's float64 gradient
# (the same draws) the JAX package's float32 gradient is 1.23e-5 of max(1,
# max |g|) off and the port's 1.03e-5, and they differ by up to 1.14e-5 (on
# this box). Held at twice GRAD_RTOL; the transformer step at GRAD_RTOL.
TCN_STEP_GRAD_RTOL = 2 * GRAD_RTOL


@pytest.fixture(scope="module")
def jax_cases():
    return torch_encoder_cases.load()


@pytest.mark.parametrize("model,encoder", torch_encoder_cases.STEPPED)
def test_train_step_matches_jax(jax_cases, model, encoder):
    """One train-mode step's every loss, every parameter gradient and the
    running statistics after it: the VQ-VAE with the TCN (its decoder
    twice in one step, moving its statistics twice), VaDE with the
    transformer (the JAX package's dropout masks, drawn by its encoder and
    decoder, and its noise draws passed in)."""
    case = jax_cases[f"step-{model}-{encoder}"]
    params, stats, logs, masks = case["params"], case["stats"], case["out"], case["masks"]
    assert (len(masks) > 0) == (encoder == "transformer")
    x, a, _ = torch_encoder_cases.model_inputs(model, encoder)
    pm = carried(model, encoder, params, stats)
    use_dropout_draws(pm, DropoutDraws(masks=masks))
    xt, at = torch.as_tensor(x), torch.as_tensor(a)
    if model == "VQVAE":
        total, got = pharness.vqvae_loss(pm, xt, at)
    else:
        loss_params = plosses.vade_params_from_cfg(pconfig.CommonFitCfg(n_components=K), pconfig.VaDECfg(),
                                                   pconfig.TurtleTeacherCfg(), False)
        total, got = pharness.vade_step_loss(pm, xt, at, None, loss_params, 0.6,
                                             torch.as_tensor(case["draws"]["eps_z"]),
                                             torch.as_tensor(case["draws"]["eps_kl"]))
    assert set(got) == set(logs)
    for k, v in logs.items():
        _close(got[k], np.asarray(v), 1e-4 if k in ("total_loss", "reconstruct_loss", "enc_rec_loss") else 1e-5)
    total.backward()
    param_grads_close(pm, case["grads"], model, stats, TCN_STEP_GRAD_RTOL if encoder == "TCN" else GRAD_RTOL)
    running_stats_close(pm, case["moved"], model, params)


def test_reference_file_is_tied_to_its_sources(tmp_path, monkeypatch):
    """``load`` checks the file's provenance: the digest over the JAX
    package's sources, the writer and the inputs is the stored one, and a
    byte added to one JAX source changes it, so that ``load`` fails."""
    stored = str(np.load(torch_encoder_cases.REFERENCE)["provenance"])
    assert torch_encoder_cases.provenance() == stored
    copy = tmp_path / "deepof_tpu"
    shutil.copytree(torch_encoder_cases.JAX_PACKAGE, copy, ignore=shutil.ignore_patterns("__pycache__"))
    zoo = copy / "models" / "zoo.py"
    zoo.write_text(zoo.read_text() + "\n")
    monkeypatch.setattr(torch_encoder_cases, "JAX_PACKAGE", str(copy))
    with pytest.raises(AssertionError, match="write it again"):
        torch_encoder_cases.load()
