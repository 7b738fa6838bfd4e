"""Causal / sliding-window GQA flash attention (prefill)."""
