"""Event streams and synthetic datasets (numpy-side; counterpart of
repro.graph)."""
