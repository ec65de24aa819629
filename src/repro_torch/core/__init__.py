"""Batching machinery and PRES trackers (counterpart of repro.core)."""
