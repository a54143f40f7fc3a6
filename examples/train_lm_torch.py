"""End-to-end LM training on the PyTorch port: a synthetic Markov token
stream -> the train loop -> checkpoint and resume, on the card.

    PYTHONPATH=src python examples/train_lm_torch.py --arch qwen2-1.5b \
        --steps 200 [--device cpu] [--resume DIR]

``--arch`` takes any of the ten assigned architectures. Like the
reference it trains ``.reduced()`` (``--no-reduced``: the published
widths, which need the card's memory and, for the largest archs, more
than one card). ``--resume DIR`` checkpoints into ``DIR`` and, when it
holds a checkpoint, resumes from its latest step.
"""
import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (load_state_tree, make_train_state,
                                          make_train_step, state_tree)


def synthetic_batches(cfg, batch: int, seq: int, seed: int = 0):
    """Markov-chain token stream (learnable structure, no external data):
    the reference's generator, draw for draw."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    trans = rng.dirichlet(np.full(min(v, 64), 0.1), size=v)
    vocab_map = rng.integers(0, v, size=min(v, 64))
    while True:
        toks = np.zeros((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, size=batch)
        for t in range(seq):
            nxt = [vocab_map[rng.choice(min(v, 64), p=trans[toks[i, t]])]
                   for i in range(batch)]
            toks[:, t + 1] = nxt
        batch_d = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.n_frontend_tokens:
            batch_d["frontend"] = rng.normal(
                size=(batch, cfg.n_frontend_tokens,
                      cfg.d_model)).astype(np.float32) * 0.1
        yield batch_d


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    opt = OptConfig(name=cfg.optimizer, lr_peak=3e-3, warmup_steps=20,
                    decay_steps=args.steps)
    state = make_train_state(cfg, opt, seed=0, device=args.device)
    n_params = sum(p.numel() for p in state["params"].parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"optimizer={opt.name}")

    ckpt = Checkpointer(args.resume or
                        tempfile.mkdtemp(prefix=f"train_{cfg.name}_"))
    if args.resume and ckpt.latest_step() is not None:
        state = load_state_tree(state, ckpt.restore(state_tree(state)))
        print(f"resumed from step {int(state['step'])}")

    step_fn = make_train_step(cfg, opt)
    data = synthetic_batches(cfg, args.batch, args.seq)
    t0, done = time.perf_counter(), 0
    m = None
    for i in range(int(state["step"]), args.steps):
        state, m = step_fn(state, next(data))
        done += 1
        if (i + 1) % args.ckpt_every == 0:
            ckpt.save(i + 1, state_tree(state))
        if (i + 1) % 20 == 0 or i == 0:
            _sync(args.device)
            dt = time.perf_counter() - t0
            print(f"step {i+1:4d} loss={float(m['loss']):.4f} "
                  f"acc={float(m['accuracy']):.3f} "
                  f"lr={float(m['lr']):.2e} "
                  f"tok/s={done * args.batch * args.seq / dt:.0f}")
            t0, done = time.perf_counter(), 0
    ckpt.wait()
    print(f"done; checkpoints in {ckpt.dir}")
    return state, m


if __name__ == "__main__":
    main()
