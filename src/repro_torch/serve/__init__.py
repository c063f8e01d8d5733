"""Serving: the micro-batching ``cell``.  Import the submodule directly."""
