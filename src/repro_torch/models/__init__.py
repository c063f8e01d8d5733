"""The language models (``base``, ``layers``, ``embedding``,
``attention``, ``moe``, ``transformer``), ported from ``repro.models``."""
