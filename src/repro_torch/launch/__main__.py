"""``python -m repro_torch.launch``: see ``repro_torch.launch.cli``.

The ranks' entry point lives in ``cli``, not here: a spawned rank finds
its function by module name, and ``__main__`` is not one it can
import.
"""
from repro_torch.launch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
