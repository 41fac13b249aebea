"""deepof_tpu_torch: the PyTorch + CUDA port of deepof_tpu for NVIDIA Hopper.

It covers the serving path (pose tables or raw keypoints -> fused
preprocess -> merged per-frame features -> device scaling -> stride-1
windows -> the recurrent + CensNet VQ-VAE encoder -> embeddings and soft
counts) and the VQ-VAE's training (``Coordinates.deep_unsupervised_embedding``
-> ``train.harness.fit_vqvae`` -> a saved ``ModelBundle``). Its hand-written
CUDA kernels (window gather, the fused masked GRU layer and its backward)
live in ``csrc/`` and are built with nvcc at first use.

Entry points take ``device=`` and default to ``"cuda"``; they raise when no
GPU is present unless the caller asks for ``"cpu"``, where each kernel's
plain PyTorch version runs. The package imports torch, numpy and scipy, and
nothing of JAX or of ``deepof_tpu``.
"""

__version__ = "0.1.0"
