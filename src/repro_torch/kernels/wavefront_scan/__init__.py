"""The timing pass of one wave: segmented queue recovery."""
