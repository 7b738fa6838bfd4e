"""The MeDiC block-pool gather (the pool's offload read)."""
