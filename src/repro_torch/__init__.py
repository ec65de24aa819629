"""PyTorch/CUDA port of the PRES MDGNN system (the `repro` JAX package is
the reference). Layout mirrors `src/repro/` module by module; the slice
ported so far is TGN-PRES online serving (`repro_torch.serve`), whose hot
path runs through three hand-written Hopper kernels
(`repro_torch.kernels`).

Entry points run on CUDA unless the caller passes `device="cpu"`; without
a card and without an explicit device they raise (`repro_torch.device`)."""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
