"""``StreamState`` — everything ``fit_update`` carries between batches.

The port of ``repro.streaming.state``. The state rides inside the
returned ``ClusterResult`` (``extra["stream"]``) and is checkpointable:
``save_stream``/``restore_stream`` round-trip it through
``repro_torch.checkpoint`` in the reference's leaf layout, so a restarted
coordinator resumes mid-stream with the exact tree buffers, centers,
version and random stream it died with, and continues bit for bit.

The reference's ``key`` leaf is a JAX PRNG key. Here it is two int64s,
(stream seed, keys drawn so far): every key the stream uses is
``tree.derive_seed`` of the pair, so the pair is the whole random state.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.streaming.tree import (Bucket, derive_seed, resident_rows,
                                        tree_epsilon)

# tags the stream's keys apart from other uses of the same seed
_KEY_TAG = 0x5742


@dataclasses.dataclass
class StreamState:
    """Host-side streaming-clustering state (one coordinator's view).

    The tree leaves (``levels``) are per-machine tensors on ``device``;
    the rest is host bookkeeping. ``version`` increments on every center
    change: serving snapshots (``repro_torch.streaming.serve``) are tagged
    with it, so a served assignment can always be traced to the exact
    center set that produced it.
    """
    levels: List[Optional[Bucket]]      # level l -> ((m, t, d), (m, t))
    occupied: List[bool]                # binary counter over folded batches
    centers: np.ndarray                 # (k, d) f32 current serving centers
    version: int                        # monotone center-snapshot version
    key: np.ndarray                     # (2,) int64: (seed, keys drawn)
    k: int
    m: int
    t: int                              # per-machine rows per tree node
    kb: int                             # bicriteria centers per compression
    device: torch.device = torch.device("cuda")
    n_seen: float = 0.0                 # folded weight mass
    ref_cost: float = float("nan")      # per-weight tree cost at the last
                                        # full re-cluster (drift reference)
    n_updates: int = 0
    n_reclusters: int = 0               # full SOCCER escalations fired
    uplink_points: List[int] = dataclasses.field(default_factory=list)
    uplink_bytes: List[int] = dataclasses.field(default_factory=list)

    def next_key(self) -> int:
        """The stream's next key (a generator seed); advances the state."""
        seed = derive_seed(_KEY_TAG, int(self.key[0]), int(self.key[1]))
        self.key = self.key + np.asarray([0, 1], np.int64)
        return seed

    def generator(self) -> torch.Generator:
        """A generator on the stream's device seeded by ``next_key``."""
        return torch.Generator(self.device).manual_seed(self.next_key())

    # ------------------------------------------------------ accounting
    @property
    def height(self) -> int:
        return len(self.levels)

    @property
    def resident_rows_per_machine(self) -> int:
        """Rows held per machine: O(t log n) by the merge-and-reduce
        invariant (== t * popcount(batches))."""
        return resident_rows(self.occupied, self.t)

    @property
    def epsilon_bound(self) -> float:
        """Compounded coreset relative-error bound at the current height."""
        return tree_epsilon(self.occupied, self.t)


# ----------------------------------------------------------- checkpoint
# StreamState is flattened to an arrays-only dict for the Checkpointer and
# rebuilt on restore. Level arrays are keyed by index; unoccupied levels
# are stored as zeros (their occupancy bit is what matters).

def _state_tree(state: StreamState) -> dict:
    tree = {
        "centers": np.asarray(state.centers, np.float32),
        "key": np.asarray(state.key, np.int64),
        "occupied": np.asarray(state.occupied, bool),
        "ints": np.asarray([state.version, state.k, state.m, state.t,
                            state.kb, state.n_updates, state.n_reclusters],
                           np.int64),
        "floats": np.asarray([state.n_seen, state.ref_cost], np.float64),
        "uplink_points": np.asarray(state.uplink_points, np.int64),
        "uplink_bytes": np.asarray(state.uplink_bytes, np.int64),
    }
    zero_p = np.zeros((state.m, state.t, state.centers.shape[1]),
                      np.float32)
    zero_w = np.zeros((state.m, state.t), np.float32)
    for lvl, bucket in enumerate(state.levels):
        pts, wts = bucket if bucket is not None else (zero_p, zero_w)
        tree[f"level_{lvl:02d}_pts"] = pts
        tree[f"level_{lvl:02d}_wts"] = wts
    return tree


def save_stream(ck: Checkpointer, step: int, state: StreamState,
                blocking: bool = True) -> None:
    """Snapshot the stream (tree buffers + centers + version) atomically."""
    ck.save(step, _state_tree(state), blocking=blocking)


def restore_stream(ck: Checkpointer, step: Optional[int] = None,
                   device: DeviceLike = "cuda") -> StreamState:
    """Rebuild a ``StreamState`` from a checkpoint (latest by default),
    its tree buffers on ``device``.

    The leaf manifest carries every shape/dtype, so no template from the
    caller is needed: a cold-started coordinator can resume a stream it
    knows nothing about.
    """
    dev = resolve_device(device)
    step = ck.latest_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no stream checkpoints in {ck.dir}")
    manifest = json.loads(
        (ck.dir / f"step-{step}" / "manifest.json").read_text())
    template = {name: np.zeros(meta["shape"], meta["dtype"])
                for name, meta in manifest["leaves"].items()}
    data = ck.restore(template, step)

    ints = data["ints"].astype(int)
    occupied = [bool(o) for o in data["occupied"]]
    levels: List[Optional[Bucket]] = []
    for lvl in range(len(occupied)):
        if occupied[lvl]:
            levels.append((
                torch.as_tensor(data[f"level_{lvl:02d}_pts"], device=dev),
                torch.as_tensor(data[f"level_{lvl:02d}_wts"], device=dev)))
        else:
            levels.append(None)
    return StreamState(
        levels=levels, occupied=occupied,
        centers=np.asarray(data["centers"], np.float32),
        version=int(ints[0]), key=np.asarray(data["key"], np.int64),
        k=int(ints[1]), m=int(ints[2]), t=int(ints[3]), kb=int(ints[4]),
        device=dev,
        n_seen=float(data["floats"][0]), ref_cost=float(data["floats"][1]),
        n_updates=int(ints[5]), n_reclusters=int(ints[6]),
        uplink_points=[int(v) for v in data["uplink_points"]],
        uplink_bytes=[int(v) for v in data["uplink_bytes"]])
