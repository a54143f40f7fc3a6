"""Streaming clustering service: merge-and-reduce trees, ``fit_update``,
versioned serving, and the stream measurement protocol (the port of
``repro.streaming``).

    from repro_torch.api import fit, fit_update
    from repro_torch.streaming import serve

    res = fit(x0, k=25)                      # batch bootstrap
    res = fit_update(res, x_new)             # fold + warm start (+ drift)
    snap = serve.snapshot(res)
    assign, d2, version = serve.serve_assign(snap, queries)

The reference also exports ``TRACE_COUNTS`` (its jit-trace counter);
eager PyTorch traces nothing, so the port has none.
"""
from repro_torch.streaming.state import (StreamState, restore_stream,
                                         save_stream)
from repro_torch.streaming.tree import (flatten_tree, fold_batch,
                                        resident_rows, stream_bucket,
                                        tree_epsilon)
from repro_torch.streaming.update import fit_update, init_stream
from repro_torch.streaming.serve import (CenterSnapshot, serve_assign,
                                         snapshot)
from repro_torch.streaming.protocol import (StreamPolicy, run_stream,
                                            run_stream_suite)

__all__ = [
    "CenterSnapshot", "StreamPolicy", "StreamState", "fit_update",
    "flatten_tree", "fold_batch", "init_stream", "resident_rows",
    "restore_stream", "run_stream", "run_stream_suite", "save_stream",
    "serve_assign", "snapshot", "stream_bucket", "tree_epsilon",
]
