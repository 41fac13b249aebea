"""Inference over recordings (training waits for a later slice)."""
