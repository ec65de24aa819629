"""Host-side utilities (counterpart of repro.utils)."""
