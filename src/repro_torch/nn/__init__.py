"""Layers of the model zoo (counterpart of `repro/nn/`)."""
