"""Index building and search: the counterpart of ``repro.core``, with the
same public names.

The paper's primary contribution: QLBT (``tree.py``), two-level
approximate search (``two_level.py``), the §5.3 configuration protocol
(``protocol.py``), and the mesh-sharded datacenter extension
(``distributed.py``).

The names are resolved on first use (a module ``__getattr__``), so that
importing one submodule, as the kernels' plain versions import
``core.brute``, does not import the index layer that itself imports the
kernels.
"""
from __future__ import annotations

import importlib

_SOURCES = {
    "DeltaManifest": "delta",
    "SearchIndex": "index", "auto_build_index": "index",
    "build_index": "index",
    "LexicalSlabs": "lexical", "build_lexical_slabs": "lexical",
    "query_operands": "lexical",
    "beta_for_unbalance": "likelihood",
    "simulate_beta_likelihood": "likelihood",
    "unbalance_score": "likelihood",
    "FilterSpec": "metadata", "MetadataTable": "metadata",
    "IndexSpec": "protocol", "select_index_spec": "protocol",
    "build_kd_tree": "tree", "build_qlbt": "tree", "build_rp_tree": "tree",
    "tree_search": "tree",
    "TwoLevelConfig": "two_level", "TwoLevelIndex": "two_level",
    "build_two_level": "two_level",
}

__all__ = list(_SOURCES)


def __getattr__(name: str):
    module = _SOURCES.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
