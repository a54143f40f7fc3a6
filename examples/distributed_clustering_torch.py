"""Production-shaped SOCCER run through the PyTorch port's facade, on the
card: per-round checkpointing and machine-failure injection via the
``on_round`` hook, straggler handling, baseline comparison, final
k-reduction.

    PYTHONPATH=src python examples/distributed_clustering_torch.py \
        [--machines 8] [--device cpu]

The port runs every fit on the virtual backend (all machines on one
device); ``backend="mesh"`` is not ported yet.
"""
import argparse
import tempfile

import torch

from repro_torch.api import fit
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.soccer_paper import GaussianMixtureSpec
from repro_torch.core.comm import VirtualCluster
from repro_torch.core.metrics import centralized_cost
from repro_torch.core.reduce import weighted_reduce
from repro_torch.data.synthetic import gaussian_mixture, shard_points
from repro_torch.ft.failures import fail_machines, surviving_fraction


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--machines", type=int, default=8)
    ap.add_argument("--n", type=int, default=80_000)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--fail", type=int, nargs="*", default=[3],
                    help="machine ids to kill after round 1")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0,
                    help="the fits' seed (the data stays the same)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    x, _, means = gaussian_mixture(
        GaussianMixtureSpec(n=args.n, dim=15, k=args.k, sigma=0.001))
    parts = shard_points(x, args.machines)
    xg = torch.as_tensor(x, device=dev)

    ckpt = Checkpointer(tempfile.mkdtemp(prefix="soccer_ckpt_"))

    def on_round(r, state):
        """Host hook after every round: checkpoint, then inject failures."""
        # the state's tensors and its random stream's position
        ckpt.save(r, {**{name: v for name, v in vars(state).items()
                         if isinstance(v, torch.Tensor)},
                      "gen_state": state.gen.get_state()})
        print(f"round {r}: N={int(state.n_remaining)} "
              f"v={float(state.v_hist[r-1]):.3g}")
        if r == 1 and args.fail:
            state = fail_machines(state, args.fail)
            print(f"  !! killed machines {args.fail} "
                  f"(surviving data: {surviving_fraction(state):.0%})")
        return state

    res = fit(parts, k=args.k, algo="soccer", backend="virtual",
              epsilon=0.05, straggler_rate=0.1, max_rounds=25,
              eta_override=6000,          # small coordinator -> multi-round
              on_round=on_round, seed=args.seed, device=dev)
    ckpt.wait()
    print(f"finished in {res.rounds} rounds, |C_out|={res.centers.shape[0]}, "
          f"uplink={res.uplink_points_total} pts "
          f"({res.uplink_bytes_total/1e6:.1f} MB)")

    state = res.extra["state"]
    final_k = weighted_reduce(torch.Generator(dev).manual_seed(1),
                              VirtualCluster(args.machines), state.x,
                              state.w, torch.as_tensor(res.centers,
                                                       device=dev),
                              k=args.k)
    cost = float(centralized_cost(xg, final_k))
    opt = float(centralized_cost(xg, torch.as_tensor(means, device=dev)))
    kp = fit(parts, k=args.k, algo="kmeans_parallel",
             backend="virtual", rounds=max(res.rounds, 1), seed=args.seed,
             device=dev)
    kp_cost = kp.cost(xg, device=dev)
    print(f"SOCCER cost (k centers, after failures): {cost:.4f} "
          f"({cost/opt:.2f}x optimal)")
    print(f"k-means|| with the same rounds:          {kp_cost:.4f} "
          f"({kp_cost/opt:.2f}x optimal)")
    return cost / opt, kp_cost / opt


if __name__ == "__main__":
    main()
