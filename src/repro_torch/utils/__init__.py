"""Hashing primitives and device selection."""
