"""Run a tree's ``chip_smoke.py`` with the wall time of each phase printed.

    python3 scripts/smoke_phase_times.py path/to/chip_smoke.py

Loads the given script as the module ``chip_smoke`` (its folder first on
``sys.path`` and as the working directory, so its worker processes import
it by that name), wraps every module-level function whose name ends in
``_phase`` so that a call made by ``main`` itself prints ``phase <name>:
<s> s`` as it returns (a phase called inside another is counted in that
one), runs ``main``, then prints one line with every phase's seconds
summed by name. This times the phases of a tree whose ``main`` does not
print them (trees before the smoke's own ``timed_phase``), so that two
trees' phases can be set side by side from one chip call. Needs the card,
as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import functools
import importlib.util
import os
import sys
import time


def main() -> None:
    path = os.path.abspath(sys.argv[1])
    folder = os.path.dirname(path)
    sys.path.insert(0, folder)
    os.chdir(folder)
    sys.argv = [path]
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)

    seconds, depth = {}, [0]

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            depth[0] += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    sec = time.perf_counter() - t0
                    seconds[fn.__name__] = seconds.get(fn.__name__, 0.0) + sec
                    print(f"phase {fn.__name__}: {sec:.1f} s", flush=True)
        return call

    for name in list(vars(smoke)):
        if name.endswith("_phase") and callable(getattr(smoke, name)):
            setattr(smoke, name, wrap(getattr(smoke, name)))
    smoke.main()
    print("phase seconds: " + ", ".join(
        f"{name} {sec:.1f}" for name, sec in seconds.items()) +
        f"; {sum(seconds.values()):.1f} in all", flush=True)


if __name__ == "__main__":
    main()
