"""Morpho-MNIST image measurement (numpy and scipy only)."""
