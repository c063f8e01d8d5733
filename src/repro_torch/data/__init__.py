"""Synthetic corpora (``synthetic``)."""
