"""Serving runtime: checkpoints, block policy, continuous batching."""
