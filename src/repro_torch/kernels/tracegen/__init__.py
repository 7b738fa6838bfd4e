"""Trace generation's per-cell draws: one thread a cell on the card."""
