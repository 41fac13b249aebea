"""Device and working-precision rules shared by every entry point."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises rather than fall back.

    A CUDA request without a visible GPU raises: the port never carries on
    on the CPU unless the caller asked for ``"cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "deepof_tpu_torch: no CUDA device is available; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU"
            )
        # Full float32 on the card. cuDNN convolutions default to TF32,
        # which keeps ~3 decimal digits: the RecurrentBlock conv would then
        # miss the 1e-5 parity bar. Matmuls default to full float32; both
        # switches are pinned here so the path states its own precision.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def working_dtype(dev: torch.device, dtype) -> torch.dtype:
    """float64 on the CPU when given float64, float32 everywhere else
    (the JAX package's rule, deepof_tpu/data.py:2210-2213)."""
    if isinstance(dtype, torch.dtype):
        is64 = dtype == torch.float64
    else:
        is64 = np.dtype(dtype) == np.float64
    return torch.float64 if (dev.type == "cpu" and is64) else torch.float32


def to_device(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """numpy array or tensor -> tensor on ``dev`` in ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def host_array(x) -> np.ndarray:
    """A table's values as a host array: a numpy array, a tensor, or
    anything with ``.values`` (a ``posthoc.Labelled``, a DataFrame)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "values") and not isinstance(x, np.ndarray):
        x = x.values
    return np.asarray(x)


def fetch_together(tensors) -> list:
    """Device tensors -> host numpy arrays, through one device-to-host copy
    (per dtype: tensors of one dtype are concatenated and copied at once)."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, x in enumerate(tensors):
        by_dtype.setdefault(x.dtype, []).append(i)
    for idx in by_dtype.values():
        host = torch.cat([tensors[i].reshape(-1) for i in idx]).cpu().numpy()
        start = 0
        for i in idx:
            x = tensors[i]
            out[i] = host[start:start + x.numel()].reshape(tuple(x.shape))
            start += x.numel()
    return out
