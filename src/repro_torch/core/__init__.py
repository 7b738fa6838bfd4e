"""Simulator core: warp types, classifier, policy presets, trace
generation and the engines."""
