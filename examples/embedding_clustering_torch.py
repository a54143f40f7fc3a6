"""SOCCER on an LM's token-embedding table with the PyTorch port: cluster
the rows through the same ``fit()`` front end used for raw data (e.g. for
codebook / prototype construction), on the card.

    PYTHONPATH=src python examples/embedding_clustering_torch.py \
        [--device cpu] [--full]

Like the reference it clusters the ``.reduced()`` config's table unless
``--full`` asks for the published widths (qwen2-1.5b: 151,936 x 1,536;
``--arch kimi-k2-1t-a32b --full``: 163,840 x 7,168). It builds only the
table, the first draw of ``init_lm(cfg, seed=0)``, so it equals that
model's ``embed`` without the rest of it (kimi-k2's whole model would be
1 T parameters).
"""
import argparse

import torch

from repro_torch.api import fit
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models.layers import init_embedding


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--full", action="store_true",
                    help="published widths instead of .reduced()")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    cfg = cfg if args.full else cfg.reduced()
    gen = torch.Generator(resolve_device(args.device)).manual_seed(0)
    emb = init_embedding(gen, cfg)                    # (V, d)
    x = emb.float()

    res = fit(x, k=args.k, algo="soccer", backend="virtual", m=args.m,
              epsilon=0.2, seed=0, device=args.device)
    print(f"clustered {x.shape[0]} '{args.arch}' token embeddings "
          f"(d={emb.shape[1]}) into {res.centers.shape[0]} prototypes "
          f"in {res.rounds} round(s); "
          f"cost={res.cost(x, device=args.device):.4f}")
    return res


if __name__ == "__main__":
    main()
