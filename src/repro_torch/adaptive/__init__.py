"""Online workload adaptation: serving-time telemetry back into the index.

Port of ``repro/adaptive``.  The paper boosts the tree once at build time
from a static likelihood vector; real traffic is skewed *and shifting*.
This package closes the loop:

  * :mod:`repro_torch.adaptive.sketch` — fixed-shape decayed count-min
    sketch with heavy-hitter tracking, in torch on the card;
  * :mod:`repro_torch.adaptive.estimator` — ``OnlineLikelihoodEstimator``
    turns returned entity ids into a smoothed likelihood and drift
    metrics;
  * :mod:`repro_torch.adaptive.maintenance` — ``MaintenanceScheduler``
    triggers incremental ``reboost``/``rebalance`` past a drift threshold
    and republishes through ``ServingCell.apply_updates`` (or a
    ``CellRouter``'s rolling fan-out);
  * :mod:`repro_torch.adaptive.cache` — ``FrequencyAdmissionCache``, a
    TinyLFU-style exact-match result cache fronting a cell.
"""
from repro_torch.adaptive.cache import FrequencyAdmissionCache
from repro_torch.adaptive.estimator import OnlineLikelihoodEstimator
from repro_torch.adaptive.maintenance import (HostIndexBackend,
                                              MaintenanceScheduler)
from repro_torch.adaptive.sketch import CountMinSketch

__all__ = [
    "CountMinSketch",
    "FrequencyAdmissionCache",
    "HostIndexBackend",
    "MaintenanceScheduler",
    "OnlineLikelihoodEstimator",
]
