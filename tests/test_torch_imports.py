"""The port stands alone: no module of `accelerate_tpu_torch` (the
quantized-compute and offload modules included), nor `chip_smoke.py` or the
`perf/torch_*.py` scripts, imports JAX or the JAX package, and every entry
point defaults to the card and refuses to fall back to the CPU on its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from accelerate_tpu_torch import FsdpPlugin, host_offloaded_adamw, optim, resolve_device
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models import llama
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.ops.flash_attention import flash_attention
from accelerate_tpu_torch.ops.fp8 import fp8_einsum
from accelerate_tpu_torch.ops.int8 import int8_einsum
from accelerate_tpu_torch.utils.quantization import quantize_pytree

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "accelerate_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "accelerate_tpu"}


def _sources():
    scripts = [ROOT / "chip_smoke.py", ROOT / "perf" / "torch_serve_profile.py",
               ROOT / "perf" / "torch_train_profile.py", ROOT / "perf" / "torch_quant_bench.py",
               ROOT / "perf" / "torch_offload_bench.py"]
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


def test_the_guard_covers_the_quantized_modules():
    names = set(_module_names())
    for module in ("utils.quantization", "ops.int8", "ops.fp8", "native.quant_matmul"):
        assert f"accelerate_tpu_torch.{module}" in names
    assert (PKG / "native" / "csrc" / "quant_matmul.cu").is_file()


def test_the_guard_covers_the_offload_modules():
    names = set(_module_names())
    for module in ("parallel", "parallel.host_offload", "native.fused_adamw"):
        assert f"accelerate_tpu_torch.{module}" in names
    assert (PKG / "native" / "csrc" / "fused_adamw.cu").is_file()


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for name in {_module_names()!r} + ['chip_smoke', 'perf.torch_serve_profile', 'perf.torch_train_profile', 'perf.torch_quant_bench', 'perf.torch_offload_bench']:\n"
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
            lambda: Accelerator(mixed_precision="bf16"),
            lambda: Accelerator(mixed_precision="fp8"),
            lambda: Accelerator(strategy=FsdpPlugin(offload_optimizer=True)),
        ],
        ids=["init", "init_cache", "params_from_jax", "accelerator", "accelerator_fp8", "accelerator_offload"],
    )
    def test_entry_points_default_to_cuda(self, no_cuda, entry):
        with pytest.raises(RuntimeError, match="CUDA"):
            entry()

    def test_tensor_entry_points_follow_their_operands(self, no_cuda):
        """`ops.flash_attention` and `optim.adamw` take no device: they run
        where their tensors are, and a CPU tensor is never moved."""
        q = torch.zeros(1, 32, 2, 16)
        assert flash_attention(q, q, q).device.type == "cpu"
        p = torch.zeros(2, requires_grad=True)
        opt = optim.adamw(1e-3).init([p])
        p.grad = torch.ones(2)
        opt.step()
        assert p.device.type == "cpu"
        for offload in (False, True):
            q = torch.zeros(2, 3, requires_grad=True)
            fused = host_offloaded_adamw(1e-3).init([q], ["blocks.w"], offload=offload)
            q.grad = torch.ones(2, 3)
            fused.step()
            assert q.device.type == "cpu" and fused.state[q]["mu"].device.type == "cpu"
        w = torch.randn(64, 80)
        node = quantize_pytree({"w": w})["w"]
        assert node["__quant__"].device.type == "cpu"
        x = torch.randn(2, 3, 64)
        assert int8_einsum("bsd,df->bsf", x, node["__quant__"], node["scale"]).device.type == "cpu"
        assert fp8_einsum("bsd,df->bsf", x, w).device.type == "cpu"
