"""The model zoo, in torch (port of ``repro.models``): the dense family so
far. Attention runs through the hand-written kernels of ``kernels/``."""
