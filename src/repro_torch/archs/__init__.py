"""The model zoo's architectures (counterpart of `repro/archs/`): the
dense decoder family and xLSTM so far."""
