"""The cache/classifier pass of one wave."""
