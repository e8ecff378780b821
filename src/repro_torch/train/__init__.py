"""Optimizer and train step of the closed training loop."""
