"""Optimizers, train step and checkpointing."""
