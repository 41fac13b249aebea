"""Training of the VaDE and the VQ-VAE (``harness``, with ``losses``, ``schedules`` and ``gmm``) and inference over recordings (``inference``)."""
