"""The port stands alone: no module of `accelerate_tpu_torch`, nor
`chip_smoke.py` or `perf/torch_serve_profile.py`, imports JAX or the JAX
package, and every entry point defaults to the card and refuses to fall
back to the CPU on its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from accelerate_tpu_torch import resolve_device
from accelerate_tpu_torch.models import llama
from accelerate_tpu_torch.models.convert import params_from_jax

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "accelerate_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "accelerate_tpu"}


def _sources():
    scripts = [ROOT / "chip_smoke.py", ROOT / "perf" / "torch_serve_profile.py"]
    return sorted(PKG.rglob("*.py")) + scripts


def _module_names():
    names = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        names.append(".".join(parts))
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_import_statement(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [alias.name.split(".")[0] for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not FORBIDDEN & set(roots), f"{path.name}:{node.lineno} imports {roots}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for name in {_module_names()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env,
        cwd=str(ROOT / "tests"),
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


class TestDeviceDefaults:
    @pytest.fixture
    def no_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def test_resolve_device(self, no_cuda):
        assert resolve_device("cpu") == torch.device("cpu")
        for dev in (None, "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="CUDA"):
                resolve_device(dev)

    @pytest.mark.parametrize(
        "entry",
        [
            lambda: llama.init(llama.LlamaConfig.tiny()),
            lambda: llama.init_cache(llama.LlamaConfig.tiny(), 1, 8),
            lambda: params_from_jax({}, llama.LlamaConfig.tiny()),
        ],
        ids=["init", "init_cache", "params_from_jax"],
    )
    def test_entry_points_default_to_cuda(self, no_cuda, entry):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()
