"""Hand-written Hopper kernels of the wavefront and serving engines and of
the models' recurrent layers, each beside its plain PyTorch version
(``ref.py``) and behind a backend gate (``ops.py``). ``_build`` compiles
``csrc/*.cu`` at first use."""
