"""Pose-table input."""
