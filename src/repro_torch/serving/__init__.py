"""Altitude B, in torch (port of ``repro.serving``): the MeDiC KV-block
pool (host numpy), the request model, and ``ServeEngine``, which runs a
dense decoder LM on the card with its KV cache managed block by block by
the pool. ``pool_ref.py`` and ``sim/`` are not ported yet (ROADMAP A7)."""
