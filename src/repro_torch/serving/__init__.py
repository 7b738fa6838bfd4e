"""Altitude B, in torch (port of ``repro.serving``): the MeDiC KV-block
pool (host numpy) and its dict-based oracle (``pool_ref.py``), the request
model, ``ServeEngine``, which runs a dense decoder LM on the card with its
KV cache managed block by block by the pool, and the open-loop serving
simulator (``sim/``), the engine's timing and accounting view, on the host
in numpy as in the reference."""
