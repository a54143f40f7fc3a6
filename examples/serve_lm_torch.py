"""Batched serving on the PyTorch port: prefill a prompt batch, then
decode greedily through the KV cache, on the card.

    PYTHONPATH=src python examples/serve_lm_torch.py --arch zamba2-2.7b \
        --steps 32 [--device cpu] [--full]

``--arch`` takes any of the ten assigned architectures (the dense, moe,
vlm, audio, hybrid and ssm families); the default is the reference's,
zamba2-2.7b. Like the reference it runs ``.reduced()`` unless ``--full``
asks for the published widths (kimi-k2-1t-a32b's whole model is 1 T
parameters and fits no single card).
"""
import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models.model import init_lm
from repro_torch.serve.decode import prefill, serve_step


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-2.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--full", action="store_true",
                    help="published widths instead of .reduced()")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    cfg = cfg if args.full else cfg.reduced()
    model = init_lm(cfg, seed=0, device=args.device)
    gen = torch.Generator(args.device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=args.device)
    fe = None
    if cfg.n_frontend_tokens:
        fe = torch.randn((args.batch, cfg.n_frontend_tokens, cfg.d_model),
                         generator=gen, device=args.device) * 0.1

    max_len = args.prompt_len + args.steps + 1
    t0 = time.perf_counter()
    logits, cache = prefill(model, cfg, prompt, frontend=fe, max_len=max_len)
    _sync(args.device)
    t_prefill = time.perf_counter() - t0
    print(f"prefill: {args.batch}x{args.prompt_len} tokens "
          f"in {t_prefill*1e3:.0f} ms")

    tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(args.steps - 1):
        tok, cache = serve_step(model, cfg, tok, cache)
        out.append(tok)
    _sync(args.device)
    dt = time.perf_counter() - t0
    seq = torch.cat(out, dim=1)
    print(f"decoded {args.steps} tokens x {args.batch} seqs "
          f"in {dt*1e3:.0f} ms "
          f"({args.batch*args.steps/dt:.1f} tok/s)")
    print("sample token ids:", seq[0, :16].tolist())


if __name__ == "__main__":
    main()
