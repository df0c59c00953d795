"""Synthetic data streams of the port."""
