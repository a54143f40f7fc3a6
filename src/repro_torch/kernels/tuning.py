"""The walk's center split: measured, then the rule.

The port of ``repro.kernels.tuning``. The reference hands its Pallas
kernels panel sizes; the port's counterpart is the launch shape of the
register-blocked walk (``kernels/walk.py``), which ``min_dist``, the
Lloyd step, ``sensitivity_scores`` and ``truncated_cost`` share. Its
points a thread are the kernel's compiled ``P`` (``csrc/min_dist.cu``
refuses any other), so the one thing tuned at run time is the split of
the center axis: ``walk.slices_for_tiles``' two constants, the fewest
centers a slice takes (``min_slice``, the rule's ``walk.MIN_SLICE``) and
the blocks an SM below which the center axis is split (``fill_per_sm``,
the rule's ``walk.FILL_PER_SM``).

A lookup is keyed by the width variant (d <= 16 in registers, else any
width), a bucket of k (``K_BUCKETS``: EIM11's 173,256 centers, its
86,628-center sample, the smoke's 4,096 and SOCCER k = 1000's 1,111 each
fall into a bucket of their own) and the point dtype, and resolved in
this order:

1. a measured table of the card (``kernels/autotune.py``): the user
   cache ``~/.cache/repro_torch/tuned_<card>.json`` over the committed
   ``kernels/tuned/<card>.json``. A table names its card
   (``torch.cuda.get_device_name()``) and SM count, and a table of
   another card is never consulted;
2. else the rule's constants.

Modes, set by ``set_mode`` (and the autotune CLI; no environment
variable): ``cached`` (the default) reads the tables, ``off`` the rule
only, ``force`` runs the quick sweep once on a miss, caches it in the
user cache and uses it. Every pair handed out goes through
``normalize``, so a stale or hand-edited table can never hand a kernel
an invalid split (the slices stay >= 1, each slice of >= 1 center, under
the launch's grid limit; the wrappers size the scratch by
``walk.split_scratch_bytes`` for whatever count comes out). Lookups are
counted in ``TUNE_COUNTS`` per executed call, as ``WireTally`` counts
bytes; the metrics registry adopts it as ``kernels.tuning.autotune``.
On the CPU no lookup happens: the plain versions have no launch shape.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import pathlib
import re
from typing import Dict, Optional, Tuple

import torch

# lookup outcomes: "measured_hit", "measured_miss", "rule_only"
TUNE_COUNTS: collections.Counter = collections.Counter()

# upper bounds of the k buckets (the last bucket is every larger k)
K_BUCKETS = (256, 1_024, 2_048, 8_192, 131_072)
MODES = ("off", "cached", "force")
# normalize's cap of fill_per_sm: at most 2·64·SMs blocks a launch, so the
# slices stay under the grid's y limit (65,535) on any card of <= 512 SMs
MAX_FILL = 64

_STATE: dict = {"mode": "cached", "candidate": None}
# card stem -> merged measured entries ({} = loaded, nothing found)
_MEASURED: Dict[str, Dict[str, dict]] = {}


def set_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown tuning mode {mode!r}; expected one of "
                         f"{MODES}")
    _STATE["mode"] = mode


def mode() -> str:
    return _STATE["mode"]


@contextlib.contextmanager
def candidate(pair: Tuple[int, int]):
    """Every lookup inside returns ``pair`` (normalized), never a table:
    the sweep times its candidates so, and a ``force`` miss inside cannot
    start another sweep."""
    prev = _STATE["candidate"]
    _STATE["candidate"] = normalize(*pair)
    try:
        yield
    finally:
        _STATE["candidate"] = prev


def rule() -> Tuple[int, int]:
    """The rule's (min_slice, fill_per_sm)."""
    from repro_torch.kernels import walk
    return walk.MIN_SLICE, walk.FILL_PER_SM


def normalize(min_slice, fill_per_sm) -> Tuple[int, int]:
    """Integers, min_slice >= 1 (each slice >= 1 center), 1 <= fill_per_sm
    <= MAX_FILL. Idempotent."""
    return max(1, int(min_slice)), min(max(1, int(fill_per_sm)), MAX_FILL)


def width(d: int) -> str:
    """The walk's width variant: "regs" (d <= 16, rows in registers) or
    "any"."""
    return "regs" if d <= 16 else "any"


def k_bucket(k: int) -> str:
    for b in K_BUCKETS:
        if k <= b:
            return f"k<={b}"
    return f"k>{K_BUCKETS[-1]}"


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def key(d: int, k: int, dtype) -> str:
    """The lookup key, e.g. ``regs:k<=2048:float32``."""
    return f"{width(d)}:{k_bucket(k)}:{dtype_name(dtype)}"


def card_of(device) -> Tuple[str, int]:
    """(``torch.cuda.get_device_name``, SM count) of a CUDA device."""
    from repro_torch.kernels import walk
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev), walk.sm_count(dev)


def card_stem(card: Tuple[str, int]) -> str:
    """A file stem of a card: its name's words, then its SMs."""
    name = re.sub(r"[^A-Za-z0-9]+", "_", card[0]).strip("_")
    return f"{name}_{card[1]}sm"


def package_table_path(card: Tuple[str, int]) -> pathlib.Path:
    """The committed table of ``card`` inside the package."""
    return pathlib.Path(__file__).resolve().parent / "tuned" / \
        f"{card_stem(card)}.json"


def cache_table_path(card: Tuple[str, int]) -> pathlib.Path:
    """The user cache's table of ``card`` (the autotune CLI's default)."""
    return pathlib.Path(os.path.expanduser("~")) / ".cache" / \
        "repro_torch" / f"tuned_{card_stem(card)}.json"


def invalidate() -> None:
    """Drop the tables read in this process (after a sweep is saved)."""
    _MEASURED.clear()


def _load(card: Tuple[str, int]) -> Dict[str, dict]:
    stem = card_stem(card)
    if stem in _MEASURED:
        return _MEASURED[stem]
    table: Dict[str, dict] = {}
    # the package table first, so that the user cache overrides it
    for path in (package_table_path(card), cache_table_path(card)):
        try:
            payload = json.loads(path.read_text())
        except (OSError, ValueError):
            continue
        if (payload.get("card"), payload.get("sms")) != tuple(card):
            continue
        table.update(payload.get("entries", {}))
    _MEASURED[stem] = table
    return table


def _entry_pair(entry) -> Optional[Tuple[int, int]]:
    try:
        return normalize(entry["min_slice"], entry["fill_per_sm"])
    except (KeyError, TypeError, ValueError):
        return None


def split_params(device, d: int, k: int, dtype) -> Tuple[int, int]:
    """(min_slice, fill_per_sm) for a walk over d-wide points of
    ``dtype`` against k centers on CUDA ``device``: the sweep's
    candidate, else the card's measured table, else the rule."""
    if _STATE["candidate"] is not None:
        return _STATE["candidate"]
    if _STATE["mode"] == "off":
        TUNE_COUNTS["rule_only"] += 1
        return rule()
    card = card_of(device)
    want = key(d, k, dtype)
    pair = _entry_pair(_load(card).get(want, {}))
    if pair is None and _STATE["mode"] == "force":
        from repro_torch.kernels import autotune
        autotune.ensure_tuned(device)
        pair = _entry_pair(_load(card).get(want, {}))
    if pair is None:
        TUNE_COUNTS["measured_miss"] += 1
        return rule()
    TUNE_COUNTS["measured_hit"] += 1
    return pair
