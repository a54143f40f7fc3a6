"""Serving entry points: prefill + single-token serve_step (+ sampling).

The port of ``repro.serve.decode``. Greedy steps take the ``argmax`` of
the last logits; with ``temperature > 0`` and a ``generator`` the next
token is drawn from softmax(logits / temperature) on that
``torch.Generator`` (the reference draws with ``jax.random``; the two
streams differ, so such runs agree with the reference only in law).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.model import lm_decode_step, lm_prefill


def prefill(params, cfg, tokens, *, frontend=None, max_len: int
            ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Fill caches from a prompt; returns (last-token logits, cache)."""
    return lm_prefill(params, cfg, tokens, frontend=frontend,
                      max_len=max_len)


def _next(logits: torch.Tensor, generator: Optional[torch.Generator],
          temperature: float) -> torch.Tensor:
    """(B, 1) int32 next tokens from (B, 1, V) logits."""
    last = logits[:, -1]
    if temperature <= 0.0 or generator is None:
        nxt = torch.argmax(last, dim=-1)
    else:
        probs = torch.softmax(last / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return nxt[:, None].to(torch.int32)


def serve_step(params, cfg, token, cache, *,
               generator: Optional[torch.Generator] = None,
               temperature: float = 0.0
               ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: (B,1) token -> (B,1) next token + updated cache."""
    logits, cache = lm_decode_step(params, cfg, token, cache)
    return _next(logits, generator, temperature), cache


def generate(params, cfg, prompt, *, steps: int, max_len: int,
             frontend=None, generator: Optional[torch.Generator] = None,
             temperature: float = 0.0):
    """Greedy/temperature autoregressive generation (host loop). The
    first token after the prompt is the argmax, as in the reference.
    Returns ((B, steps) int32 tokens, cache)."""
    logits, cache = prefill(params, cfg, prompt, frontend=frontend,
                            max_len=max_len)
    tok = _next(logits, None, 0.0)
    out = [tok]
    for _ in range(steps - 1):
        tok, cache = serve_step(params, cfg, tok, cache, generator=generator,
                                temperature=temperature)
        out.append(tok)
    return torch.cat(out, dim=1), cache
