"""Memory maintenance shared with training (counterpart of repro.train)."""
