"""PyTorch / CUDA port of the MeDiC GPGPU memory-hierarchy simulator.

Mirrors the JAX package ``repro`` module for module (``repro.X.Y`` ↔
``repro_torch.X.Y``) and imports nothing of it. The wavefront engine's
two per-wave passes, the serving engine's pool gather, decode attention
and prefill attention, and the RG-LRU and mLSTM prefill run as
hand-written CUDA kernels for Hopper (``csrc/``); everything else is
plain PyTorch on tensors.
"""
