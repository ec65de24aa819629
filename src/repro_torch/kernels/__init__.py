"""Hand-written CUDA kernels, their plain PyTorch versions and the
dispatch registry (counterpart of repro.kernels). Importing this package
builds nothing: the kernels are compiled at their first CUDA launch."""
