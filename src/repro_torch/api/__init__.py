"""Clustering API of the PyTorch port: ``fit()`` over the registered
algorithms.

    from repro_torch.api import fit
    res = fit(x, k=25)                  # SOCCER on the card
    res.centers, res.rounds, res.uplink_points, res.cost(x)
    res = fit(x, k=25, trace="rounds")  # per-round records, extra["trace"]
    res = fit_update(res, x_new)        # fold a batch into a stream
"""
from repro_torch.api.registry import (get_algorithm, list_algorithms,
                                      register_algorithm)
from repro_torch.api.result import ClusterResult, uplink_bytes
from repro_torch.api.facade import fit, fit_update
from repro_torch.api import algorithms as _algorithms  # noqa: F401 (registers
                                                       # the drivers)
from repro_torch.coresets import algorithms as _coreset_algorithms  # noqa: F401
                                              # (registers coreset_kmeans)
from repro_torch import robust as _robust  # noqa: F401 (registers kzmeans)

__all__ = ["ClusterResult", "fit", "fit_update", "get_algorithm",
           "list_algorithms", "register_algorithm", "uplink_bytes"]
