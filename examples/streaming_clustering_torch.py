"""Streaming clustering on the PyTorch port, on the card: bootstrap once,
then fold / warm-start / serve.

A time-evolving mixture (drifting means + a cluster birth mid-stream)
arrives batch by batch. One batch ``fit`` bootstraps the centers; every
later batch is (1) served against the current versioned snapshot —
measuring what staleness costs — then (2) folded into the per-machine
merge-and-reduce coreset trees by ``fit_update``, which warm-starts
Lloyd from the previous centers and escalates to a full SOCCER
re-cluster only when the drift trigger fires.

    PYTHONPATH=src python examples/streaming_clustering_torch.py \
        [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.api import fit, fit_update
from repro_torch.data.synthetic import drifting_mixture
from repro_torch.streaming import serve_assign, snapshot

K, M = 8, 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    batches, _ = drifting_mixture(steps=12, n_per_step=768, k=K, dim=8,
                                  drift=0.04, sigma=0.02, birth_step=6,
                                  seed=53)

    # batch bootstrap on the first arrivals
    result = fit(batches[0], K, algo="soccer", backend="virtual", m=M,
                 seed=0, eta_override=1024, device=args.device)
    print(f"{'step':>4} {'version':>7} {'stale_cost/pt':>13} "
          f"{'uplink_rows':>11} {'re-clustered':>12}")

    for step, batch in enumerate(batches[1:], start=1):
        # serve the new arrivals against the current (stale) snapshot
        snap = snapshot(result)
        _, d2, version = serve_assign(snap, batch, device=args.device)
        stale = float(np.sum(d2)) / batch.shape[0]

        # fold + warm start (+ drift-triggered full re-cluster)
        result = fit_update(result, batch, backend="virtual", m=M,
                            refine_iters=2, drift_tol=1.5,
                            recluster_params=dict(eta_override=1024),
                            device=args.device)
        print(f"{step:>4} {version:>7} {stale:>13.4f} "
              f"{int(result.uplink_points[-1]):>11} "
              f"{str(result.extra['reclustered']):>12}")

    state = result.extra["stream"]
    print(f"\nfull re-clusters fired: {state.n_reclusters} "
          f"(the birth at step 6 is what trips the trigger)")
    print(f"resident rows/machine:  {state.resident_rows_per_machine} "
          f"(tree height {state.height}, "
          f"eps bound {state.epsilon_bound:.3f})")
    print(f"cumulative uplink:      {int(np.sum(result.uplink_points))} "
          f"rows ({int(np.sum(result.uplink_bytes))/1e3:.0f} kB) "
          f"across {state.n_updates} updates")


if __name__ == "__main__":
    main()
