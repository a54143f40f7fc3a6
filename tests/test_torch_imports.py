"""The PyTorch port stands alone: nothing under ``src/repro_torch/``, no
``examples/*_torch.py``, nothing in ``chip_smoke.py`` and nothing in the
scripts it imports (``cuda_timing``, ``trace_overhead``) imports JAX or
the JAX package ``repro`` (only the tests import both)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
FILES = PORT + sorted((ROOT / "examples").glob("*_torch.py")) + [
    ROOT / "chip_smoke.py", ROOT / "scripts" / "cuda_timing.py",
    ROOT / "scripts" / "trace_overhead.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(ROOT))
                                             for p in FILES])
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_port_has_its_modules():
    names = {str(p.relative_to(ROOT / "src")) for p in PORT}
    for mod in ("repro_torch/api/facade.py", "repro_torch/core/soccer.py",
                "repro_torch/kernels/ops.py", "repro_torch/data/sharding.py",
                "repro_torch/configs/soccer_paper.py",
                "repro_torch/kernels/lloyd.py",
                "repro_torch/kernels/sensitivity.py",
                "repro_torch/kernels/truncated.py",
                "repro_torch/coresets/sensitivity.py",
                "repro_torch/coresets/uplink.py",
                "repro_torch/coresets/algorithms.py",
                "repro_torch/robust/kzmeans.py",
                "repro_torch/obs/trace.py", "repro_torch/obs/metrics.py",
                "repro_torch/obs/export.py", "repro_torch/obs/report.py",
                "repro_torch/api/selfcheck.py",
                "repro_torch/checkpoint/checkpointer.py",
                "repro_torch/streaming/tree.py",
                "repro_torch/streaming/state.py",
                "repro_torch/streaming/serve.py",
                "repro_torch/streaming/update.py",
                "repro_torch/streaming/protocol.py",
                "repro_torch/scenarios/__init__.py",
                "repro_torch/scenarios/registry.py",
                "repro_torch/scenarios/library.py",
                "repro_torch/scenarios/sweep.py",
                "repro_torch/scenarios/report.py",
                "repro_torch/scenarios/run.py",
                "repro_torch/api/backends.py",
                "repro_torch/core/distributed.py",
                "repro_torch/launch/__init__.py",
                "repro_torch/launch/__main__.py",
                "repro_torch/launch/cli.py",
                "repro_torch/launch/mesh.py",
                "repro_torch/configs/__init__.py",
                "repro_torch/configs/base.py",
                "repro_torch/configs/shapes.py",
                "repro_torch/configs/qwen2_1_5b.py",
                "repro_torch/models/layers.py",
                "repro_torch/models/attention.py",
                "repro_torch/models/model.py",
                "repro_torch/models/convert.py",
                "repro_torch/models/moe.py",
                "repro_torch/models/mamba2.py",
                "repro_torch/models/xlstm.py",
                "repro_torch/serve/decode.py",
                "repro_torch/train/__init__.py",
                "repro_torch/train/loss.py",
                "repro_torch/train/optimizer.py",
                "repro_torch/train/train_step.py"):
        assert mod in names
    examples = {p.name for p in FILES if p.parent.name == "examples"}
    assert examples == {"quickstart_torch.py",
                        "distributed_clustering_torch.py",
                        "streaming_clustering_torch.py",
                        "serve_lm_torch.py",
                        "embedding_clustering_torch.py",
                        "train_lm_torch.py"}


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch.api, repro_torch.kernels.ops, "
            "repro_torch.core.reduce, repro_torch.coresets, "
            "repro_torch.robust, repro_torch.fit_profile, repro_torch.obs, "
            "repro_torch.obs.report, repro_torch.api.selfcheck, "
            "repro_torch.checkpoint.checkpointer, repro_torch.streaming, "
            "repro_torch.scenarios, repro_torch.scenarios.run, "
            "repro_torch.api.backends, repro_torch.core.distributed, "
            "repro_torch.launch, repro_torch.launch.cli, "
            "repro_torch.launch.mesh, repro_torch.configs, "
            "repro_torch.models.model, repro_torch.models.convert, "
            "repro_torch.serve.decode, repro_torch.train.loss, "
            "repro_torch.train.optimizer, repro_torch.train.train_step; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
