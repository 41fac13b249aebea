"""Training of the VQ-VAE (``harness``) and inference over recordings (``inference``)."""
