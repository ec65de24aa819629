"""MDGNN model code, TGN subset (counterpart of repro.models)."""
