"""Two diagnoses of the scenario lab that no run CLI prints.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/scenario_outcomes.py \
        --round-one [--full] [--seeds 0]
    ... --removal [--package torch|jax] [--condition plain|robust] \
        [--seeds 0,1,2,3]
    ... --example distributed_clustering [--package torch|jax] \
        [--device cpu|cuda] [--seeds 0,1,2,3]

``--round-one`` (the CPU, both packages in one process) fits SOCCER on
the adversarial instance in each package, keeps the state its round 1
ran on (``repro_torch.scenarios.capture_round``), and prints, a location
at a time, how many copies survive round 1 under each package's removal
at those centers and v, each package's float32 d2 at them and the exact
(float64, difference form) d2. ``--full`` takes the scenario's full size,
else its quick one.

``--removal`` (the CPU) fits SOCCER on ``outlier_contaminated`` at full
size in one package, once a seed, and prints each round's v, how many of
its valid centers sit on an outlier (the data row nearest the center is
one of the 2% injected), how many inliers it removes and how many of
those lie farther than ``UNCOVERED`` (exact float64 d2) from every one of
the round's centers, then the fit's cost over the exact baseline on the
inliers (the sweep's ``cost_ratio``) and how many inliers end farther
than ``UNCOVERED`` from every center of its output, by the round that
removed them.

``--example`` runs one k-means example of either package (the reference's
``examples/<name>.py`` on the CPU, or the port's
``examples/<name>_torch.py`` on ``--device``) once a seed, every ``fit``
of it at that seed (the data stays the same), and prints its printout.

A scenario's rows at one seed, in either package, come from the run
CLIs: ``python -m repro.scenarios.run --suite NAME --seed S --out ''``
and ``python -m repro_torch.scenarios.run --suite NAME --seed S --device
cpu|cuda --out ''`` (Theorem 7.2's gap: ``--suite
adversarial_kmeanspar``; the streams' acceptance columns: ``--suite
streaming_drift,streaming_stationary``).
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def round_one(args) -> None:
    import jax.numpy as jnp
    import torch
    from repro.api import fit as jfit
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    from repro_torch.scenarios import capture_round, get_scenario

    def removal(pkg, x3, alive, c, cv, v):
        """(survivors, float32 d2) of one package's removal, eagerly."""
        m, p, d = x3.shape
        if pkg == "jax":
            a, _ = jops.remove_below(jnp.asarray(x3), jnp.asarray(c),
                                     jnp.asarray(alive), jnp.asarray(v),
                                     jnp.asarray(cv))
            d2, _ = jops.min_dist(jnp.asarray(x3.reshape(m * p, d)),
                                  jnp.asarray(c), jnp.asarray(cv))
        else:
            t = [torch.as_tensor(np.array(a)) for a in (x3, c, alive, v, cv)]
            a, _ = tops.remove_below(t[0], t[1], t[2], t[3], t[4])
            d2, _ = tops.min_dist(t[0].reshape(m * p, d), t[1], t[4])
        return np.asarray(a).reshape(-1), np.asarray(d2)

    sc = get_scenario("adversarial_kmeanspar")
    x, k = sc.make_data(not args.full).x, sc.k_for(not args.full)
    eta = sc.params_for("soccer", sc.conditions[0],
                        not args.full)["eta_override"]
    locs = np.unique(x, axis=0)
    norm2 = float((x.astype(np.float64) ** 2).sum(1).max())
    print(f"adversarial instance {x.shape}, k={k}, {len(locs)} locations, "
          f"eta={eta}, max ||x||^2 {norm2:.1f}")
    for seed in args.seeds:
        states = {}
        for pkg in ("jax", "torch"):
            kw = dict(m=8, seed=seed, eta_override=eta)
            res, st = (capture_round(x, k, fit_fn=jfit, backend="virtual",
                                     **kw) if pkg == "jax" else
                       capture_round(x, k, device="cpu", **kw))
            states[pkg] = {name: np.asarray(a) for name, a in st.items()}
            print(f"seed {seed} {pkg}: SOCCER rounds {res.rounds} n_hist "
                  f"{[int(n) for n in np.asarray(res.n_hist)]}", flush=True)
        for pkg, st in states.items():
            m, p, d = st["x"].shape
            xs = st["x"].reshape(m * p, d)
            eq = (xs[:, None, :] == locs[None]).all(-1)
            loc = np.where(eq.any(1), eq.argmax(1), -1)
            live = (loc >= 0).reshape(m, p)
            c, cv, v = st["c"], st["cv"], st["v"]
            diff = (xs.astype(np.float64)[:, None]
                    - c[cv].astype(np.float64)[None])
            exact = (diff * diff).sum(-1).min(1)
            surv = st["kept"].reshape(-1)
            kept, d2 = {}, {}
            for q in ("jax", "torch"):
                kept[q], d2[q] = removal(q, st["x"], live, c, cv, v)
            other = "torch" if pkg == "jax" else "jax"
            print(f"  {pkg}'s round 1: v={float(v)!r}, {int(cv.sum())} "
                  f"valid centers, {int(surv.sum())} survivors in the fit; "
                  f"eagerly at its state, jax keeps {int(kept['jax'].sum())}"
                  f", torch {int(kept['torch'].sum())}; {other}'s removal "
                  f"differs from the fit's at "
                  f"{int((kept[other] != surv).sum())} points")
            for j in range(len(locs)):
                sel = loc == j
                if not (surv[sel].any() or kept["jax"][sel].any()
                        or kept["torch"][sel].any()):
                    continue
                print(f"    location {j:2d} ({int(sel.sum())} copies): "
                      f"survivors fit {int(surv[sel].sum())}, jax "
                      f"{int(kept['jax'][sel].sum())}, torch "
                      f"{int(kept['torch'][sel].sum())}; float32 d2 jax "
                      f"{np.unique(d2['jax'][sel]).tolist()} torch "
                      f"{np.unique(d2['torch'][sel]).tolist()}; exact d2 "
                      f"{np.unique(exact[sel]).tolist()}", flush=True)


# an inlier this far (d2) from every center of its round is not covered
# by one: 100x the mixture's own spread, sigma^2 * d = 1.5e-5
UNCOVERED = 1.5e-3


def removal(args) -> None:
    pkg = args.package
    if pkg == "jax":
        from repro.api import fit as pfit
        from repro.scenarios import exact_baseline, get_scenario
        kw = dict(backend="virtual")
    else:
        from repro_torch.api import fit as pfit
        from repro_torch.scenarios import exact_baseline, get_scenario
        kw = dict(device="cpu")
    sc = get_scenario("outlier_contaminated")
    data = sc.make_data(False)
    k = sc.k_for(False)
    cond = next(c for c in sc.conditions if c.name == args.condition)
    params = sc.params_for("soccer", cond, False)
    eval_x = data.eval_x().astype(np.float64)
    n_out = int((~data.eval_mask).sum())
    for seed in args.seeds:
        base = exact_baseline(data, k, seed, sc.baseline_iters, **(
            {} if pkg == "jax" else kw))
        rounds = []

        def hook(r, state, rounds=rounds):
            rounds.append({name: np.asarray(a) for name, a in (
                ("x", state.x), ("w", state.w), ("alive", state.alive),
                ("c", state.centers[r - 1]),
                ("cv", state.centers_valid[r - 1]),
                ("v", state.v_hist[r - 1]))})
            return state

        res = pfit(data.x, k, algo="soccer", m=sc.m, seed=seed,
                   shard_policy=sc.shard_policy, on_round=hook, **params,
                   **kw)
        x3 = rounds[0]["x"]
        xs = x3.reshape(-1, x3.shape[-1]).astype(np.float64)
        # the injected outliers sit at 50x the data's radius: every inlier
        # coordinate is within 1.0004 of 0, no outlier's all are
        out = np.abs(xs).max(1) > 1.5
        real = rounds[0]["w"].reshape(-1) > 0
        assert int((out & real).sum()) == n_out, (int(out.sum()), n_out)
        before = real
        removed_at = np.zeros(len(xs), np.int64)   # 0: never removed
        print(f"{pkg} {cond.name} seed {seed}: {len(rounds)} rounds",
              flush=True)
        for r, st in enumerate(rounds, 1):
            c = st["c"][st["cv"]].astype(np.float64)
            d2c = ((xs[:, None] - c[None]) ** 2).sum(-1)
            on_out = int(out[np.argmin(d2c, 0)].sum())
            alive = st["alive"].reshape(-1)
            gone = before & ~alive & ~out
            far = gone & (d2c.min(1) > UNCOVERED)
            print(f"  round {r}: v={float(st['v']):.4g}, {len(c)} centers, "
                  f"{on_out} on an outlier; removed {int(gone.sum())} "
                  f"inliers, {int(far.sum())} of them uncovered (up to d2 "
                  f"{float(d2c.min(1)[gone].max()) if gone.any() else 0:.4g})"
                  f"; {int((alive & out).sum())} outliers left", flush=True)
            removed_at[before & ~alive] = r
            before = alive
        centers = np.asarray(res.centers, np.float64)
        cost = float(((eval_x[:, None] - centers[None]) ** 2).sum(-1)
                     .min(1).sum())
        d2_out = ((xs[:, None] - centers[None]) ** 2).sum(-1).min(1)
        lost = real & ~out & (d2_out > UNCOVERED)
        by_round = np.bincount(removed_at[lost], minlength=len(rounds) + 1)
        print(f"  cost over the exact baseline {cost / base:.6g} "
              f"({len(centers)} centers); {int(lost.sum())} inliers farther "
              f"than {UNCOVERED} from every output center, removed in "
              f"rounds 1.. {by_round[1:].tolist()} (at the finalize "
              f"{int(by_round[0])})", flush=True)


def example(args) -> None:
    name = args.example + ("_torch" if args.package == "torch" else "")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    real_fit = mod.fit
    argv = ["--device", args.device] if args.package == "torch" else []
    for seed in args.seeds:
        mod.fit = lambda *a, _seed=seed, **kw: real_fit(
            *a, **{**kw, "seed": _seed})
        t0 = time.perf_counter()
        print(f"# {name} seed {seed}", flush=True)
        if args.package == "torch":
            mod.main(argv)
        else:
            sys.argv = [name]
            mod.main()
        print(f"# {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--round-one", action="store_true")
    mode.add_argument("--removal", action="store_true")
    mode.add_argument("--example", choices=("quickstart",
                                            "distributed_clustering",
                                            "streaming_clustering"))
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--condition", choices=("plain", "robust"),
                    default="plain")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seeds", default="0",
                    type=lambda s: [int(v) for v in s.split(",")])
    args = ap.parse_args()
    import torch
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    (example if args.example else removal if args.removal
     else round_one)(args)


if __name__ == "__main__":
    main()
