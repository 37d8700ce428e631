"""Synthetic data with known cluster structure."""
