"""Paged decode attention over a KV block pool."""
