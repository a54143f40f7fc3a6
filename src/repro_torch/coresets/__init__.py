"""Distributed coresets: sensitivity-sampling shard summaries (the port of
``repro.coresets``).

* ``build_coreset`` (``sensitivity.py``): per-machine construction —
  k-means++ bicriteria solve, one sensitivity sweep
  (``kernels.ops.sensitivity_scores``), importance sampling of a weighted
  (t, d) summary with Horvitz–Thompson weights.
* ``coreset_kmeans`` (``algorithms.py``): the one-round baseline —
  gather every machine's coreset once, run weighted k-means on the
  coordinator.
* ``draw_coreset_sample`` (``uplink.py``): SOCCER's
  ``uplink_mode="coreset"``.
"""
from repro_torch.coresets.sensitivity import (build_coreset,
                                              default_coreset_size,
                                              sensitivity_sigma)
from repro_torch.coresets.uplink import draw_coreset_sample

__all__ = ["build_coreset", "default_coreset_size", "draw_coreset_sample",
           "sensitivity_sigma"]
