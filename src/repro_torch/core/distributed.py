"""Back-compat shim: the sharded search lives in ``repro_torch.distributed``.

Re-exports the distributed search entry points from
:mod:`repro_torch.distributed.sharding`, as ``repro.core.distributed``
does for the reference.  Import from ``repro_torch.distributed`` in new
code.
"""
from repro_torch.distributed.sharding import (  # noqa: F401
    make_sharded_brute_fn,
    make_sharded_forest_fn,
    make_sharded_ivf_fn,
    sharded_brute_search,
    sharded_forest_search,
    sharded_ivf_search,
)

__all__ = [
    "sharded_brute_search",
    "sharded_ivf_search",
    "sharded_forest_search",
    "make_sharded_brute_fn",
    "make_sharded_ivf_fn",
    "make_sharded_forest_fn",
]
