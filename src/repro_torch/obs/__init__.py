"""Observability: ``metrics`` (fixed-footprint counters and histograms)
and ``trace`` (spans with Chrome-trace export), copied from ``repro.obs``.
Import the submodules directly."""
