"""The LM in PyTorch: the port of `repro.models` for the dense decoder
stack (layers, attention, transformer, model) plus `convert`, which
carries the JAX package's weights over for the tests.  MoE, SSM, xLSTM,
zamba2 and whisper are not ported yet."""
