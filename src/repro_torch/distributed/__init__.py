"""Collectives with narrow wire formats (``distributed.compression``)."""
