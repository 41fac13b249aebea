"""The Contrastive model at each encoder against the JAX package's, float32
on the CPU: the encoder over half windows in eval mode (serving, encode)
and train mode (the JAX package's dropout masks given) with the running
statistics after it, and a contrastive step at the transformer encoder,
whose two forwards take the same dropout masks. The JAX package's forwards
(up to 10 s of compile each) were run once by
``scripts/make_torch_reference.py`` and are read from
``tests/data/encoder_cases.npz`` (``torch_encoder_cases``). Helpers and
bars are ``test_torch_contrastive``'s.
"""

import numpy as np
import pytest
import torch

from deepof_tpu_torch.models.blocks import DropoutDraws, use_dropout_draws
from deepof_tpu_torch.train import config as pconfig
from deepof_tpu_torch.train import harness as pharness

import torch_encoder_cases
from test_torch_contrastive import EDGES, PRECOMP, T_FULL, _carried
from test_torch_encoders import (  # noqa: F401 (one_torch_thread: an autouse fixture of this module too)
    one_torch_thread,
    running_stats_close,
)
from test_torch_train import _close

ENCODERS = ("recurrent", "TCN", "transformer")


@pytest.fixture(scope="module")
def jax_forwards():
    """encoder -> (params, stats, half windows, their edges, the JAX
    package's eval and train forwards, the batch stats after the train one,
    its dropout masks), run once by ``scripts/make_torch_reference.py``
    (``torch_encoder_cases``)."""
    cases = torch_encoder_cases.load()
    out = {}
    for encoder in ENCODERS:
        case = cases[f"fwd-Contrastive-{encoder}"]
        half = torch_encoder_cases.contrastive_inputs(case["data_seed"])[:, :T_FULL // 2]
        a = half_edges(half)
        out[encoder] = (case["params"], case["stats"], half, a, case["out"]["eval"], case["out"]["train"],
                        case["moved"], case["masks"])
    return out


def half_edges(x):
    """The JAX package's ``recompute_edges`` in numpy (float32, the same
    two-term sum and square root)."""
    d = x[:, :, EDGES[:, 0], :2] - x[:, :, EDGES[:, 1], :2]
    return np.sqrt((d * d).sum(-1, keepdims=True)).astype(np.float32)


def test_contrastive_step_shares_dropout_masks_between_views(jax_forwards, monkeypatch):
    """With the transformer encoder both forwards of a step take the same
    keep masks, drawn once from the generator, as the JAX step passes one
    dropout key to both of its forwards (``make_contrastive_step``'s
    ``rng_drop``); the step moves every parameter."""
    params, stats, half, *_ = jax_forwards["transformer"]
    served = []
    keep = DropoutDraws.keep

    def recorded(self, shape, keep_prob, device):
        mask = keep(self, shape, keep_prob, device)
        served.append(mask.clone())
        return mask

    monkeypatch.setattr(DropoutDraws, "keep", recorded)
    pm = _carried("transformer", params, stats)
    x = torch.as_tensor(np.concatenate([half, half], axis=1))
    before = {k: v.clone() for k, v in pm.named_parameters()}
    step = pharness.make_contrastive_step(pm, pharness._make_optimizer(pm.named_parameters(), 1e-3),
                                          pconfig.ContrastiveCfg(), EDGES, PRECOMP, torch.Generator().manual_seed(0))
    out = step(x)
    n = len(served) // 2
    assert n > 0 and len(served) == 2 * n
    assert all(torch.equal(a, b) for a, b in zip(served[:n], served[n:]))
    assert any(not bool(m.all()) for m in served)  # real draws, not all-keep
    assert set(out) == {"total_loss", "pos_similarity", "neg_similarity"} and np.isfinite(float(out["total_loss"]))
    assert all(not torch.equal(before[k], v) for k, v in pm.named_parameters())


@pytest.mark.parametrize("encoder", ENCODERS)
def test_contrastive_forwards_match_jax(jax_forwards, encoder):
    """The encoder over half windows, eval mode (serving, encode) and train
    mode (the JAX package's dropout masks given), and the running
    statistics after it."""
    params, stats, half, a, want_eval, want_train, moved, masks = jax_forwards[encoder]
    assert (len(masks) > 0) == (encoder == "transformer")
    pm = _carried(encoder, params, stats)
    assert pm.window_size == T_FULL // 2
    xt, at = torch.as_tensor(half), torch.as_tensor(a)
    with torch.no_grad():
        _close(pm.eval()(xt, at)["encoder_output"], want_eval)
        _close(pm.train().encode(xt, at), want_eval)
        use_dropout_draws(pm, DropoutDraws(masks=masks))
        _close(pm.training_forward(xt, at), want_train)
    if encoder != "recurrent":
        running_stats_close(pm, moved, "Contrastive", params)
