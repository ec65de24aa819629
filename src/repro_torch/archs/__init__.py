"""The model zoo's architectures (counterpart of `repro/archs/`): the
dense decoder family (and the VLM on it), xLSTM and zamba2."""
