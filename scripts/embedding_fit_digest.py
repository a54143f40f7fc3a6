"""SOCCER on kimi-k2's token-embedding table, as ``chip_smoke.py``'s
``embedding_phase`` runs it, for any tree: the fit's wall and a digest of
its result.

    python3 scripts/embedding_fit_digest.py [--src DIR]

Loads ``repro_torch`` from ``DIR`` (default: this checkout's ``src``),
builds the kernels, draws the 163,840 × 7,168 table as the smoke does
(``init_embedding`` of kimi-k2-1t-a32b's config on a CUDA generator
seeded 0, cast to float32), times the host's shard placement alone, then
``fit(x, 16, algo="soccer", m=8, epsilon=0.2, seed=0, device="cuda")``,
and prints the fit's wall, its rounds and ``n_hist``, and the sha256 of
its centers (float32) and ``n_hist`` (int64): two trees whose kernels give
the same bits print the same digest. Run it for the parent and the change
in one call (parent, change, change, parent), as fit walls vary with the
shard placement.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys
import time

import numpy as np

EMB_ARCH = "kimi-k2-1t-a32b"
EMB_K, EMB_M, EMB_EPS = 16, 8, 0.2


def fit_sha256(res) -> str:
    """sha256 of a fit's centers (float32) and then its n_hist (int64)."""
    h = hashlib.sha256(np.ascontiguousarray(res.centers,
                                            np.float32).tobytes())
    h.update(np.ascontiguousarray(res.n_hist, np.int64).tobytes())
    return h.hexdigest()


def main() -> None:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap.add_argument("--src", default=os.path.join(root, "src"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("embedding_fit_digest.py needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import api
    from repro_torch.configs import get_config
    from repro_torch.data.sharding import make_shards
    from repro_torch.kernels import build
    from repro_torch.models.layers import init_embedding

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi} src: {args.src}; build {build.build_all():.1f} s",
          flush=True)
    emb = init_embedding(torch.Generator("cuda").manual_seed(0),
                         get_config(EMB_ARCH))
    x = emb.float()
    del emb
    t0 = time.perf_counter()
    make_shards(x.cpu().numpy(), None, EMB_M, policy="shuffle", seed=0)
    place = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = api.fit(x, EMB_K, algo="soccer", m=EMB_M, epsilon=EMB_EPS, seed=0,
                  device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"fit soccer embedding table {tuple(x.shape)}: wall {wall:.3f} s "
          f"(host shard placement alone {place:.3f} s), rounds "
          f"{res.rounds}, n_hist {res.n_hist.tolist()}, |C_out| "
          f"{res.centers.shape[0]}; sha256 {fit_sha256(res)}", flush=True)


if __name__ == "__main__":
    main()
