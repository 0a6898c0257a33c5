"""The port imports neither JAX nor the JAX package, nor ``msgpack`` or
``ml_dtypes`` (the card's machine has neither).

A subprocess in which ``import jax``, ``import repro``, ``import
msgpack`` and ``import ml_dtypes`` fail imports every module of
``repro_torch``; an AST scan of the port's sources and of
``chip_smoke.py`` finds no import of any of them.
"""
import ast
import os
from pathlib import Path
import subprocess
import sys

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack", "ml_dtypes")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        parts = list(path.relative_to(ROOT / "src").with_suffix("").parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_every_module_imports_without_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.serve.engine" in mods and "repro_torch.kernels.build" in mods
    for m in ("repro_torch.models.ddpm", "repro_torch.launch.train_ddpm",
              "repro_torch.configs.paper", "repro_torch.core.flops",
              "repro_torch.core.prng", "repro_torch.serve.lockstep",
              "repro_torch.models.ssm", "repro_torch.models.moe",
              "repro_torch.configs.kimi_k2_1t_a32b", "repro_torch.configs.mamba2_1_3b",
              "repro_torch.configs.whisper_large_v3", "repro_torch.configs.paligemma_3b",
              "repro_torch.checkpoint.codec", "repro_torch.checkpoint.ckpt",
              "repro_torch.dist.fault", "repro_torch.dist.compat", "repro_torch.dist",
              "repro_torch.dist.sharding", "repro_torch.launch.mesh",
              "repro_torch.optim.compression", "repro_torch.analysis",
              "repro_torch.analysis.dispatch_walk", "repro_torch.analysis.launch_check",
              "repro_torch.analysis.lints", "repro_torch.analysis.report",
              "repro_torch.analysis.retrace", "repro_torch.analysis.savings",
              "repro_torch.kernels.specs", "repro_torch.launch.analyze",
              "repro_torch.launch.dryrun"):
        assert m in mods
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    [*sorted(PORT.rglob("*.py")), ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_source_has_no_jax_or_repro_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
