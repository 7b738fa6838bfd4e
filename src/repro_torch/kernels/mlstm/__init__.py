"""Chunkwise mLSTM with its state (prefill)."""
