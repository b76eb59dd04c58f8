"""Port flash-decode (`accelerate_tpu_torch.native.decode_attention`) against
the JAX package's Pallas kernel, run in interpret mode as its own tests run
it; plus the wrapper's checks, the launch counter and the nvcc build.

The CUDA kernel itself cannot run here: `chip_smoke.py` holds it against
`flash_decode_reference` on the card. On CPU tensors `flash_decode` IS the
plain version, so these tests pin the function the kernel must compute.

Tolerances: fp32 2e-6 (the JAX kernel test's own: both sides keep fp32
logits and softmax, and differ only in summation order); bf16 and int8
2e-2 (one bf16 rounding of the output on each side, ~4e-3 relative at
|out| ~ 1, plus the order).
"""

import os
import stat

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import llama as jax_llama
from accelerate_tpu.native.pallas import decode_attention as jax_da
from accelerate_tpu_torch.native import build, dispatch
from accelerate_tpu_torch.native import decode_attention as da


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _operands(B=2, T=64, K=2, group=2, h=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, K * group, h), dtype=np.float32)
    k = rng.standard_normal((B, T, K, h), dtype=np.float32)
    v = rng.standard_normal((B, T, K, h), dtype=np.float32)
    return q, k, v


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


class TestPlainDecodeMatchesJaxKernel:
    @pytest.mark.parametrize(
        "B,K,group,lengths",
        [(2, 2, 2, 48), (4, 2, 4, [3, 17, 64, 40]), (3, 1, 8, [1, 64, 2])],
        ids=["scalar-cursor", "ragged-gqa4", "ragged-gqa8"],
    )
    def test_f32(self, B, K, group, lengths):
        q, k, v = _operands(B=B, K=K, group=group)
        ref = jax_da.flash_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(lengths, jnp.int32), interpret=True,
        )
        lens = lengths if isinstance(lengths, int) else torch.tensor(lengths, dtype=torch.int32)
        out = da.flash_decode(_t(q), _t(k), _t(v), lens)
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=2e-6, atol=2e-6)

    def test_bf16(self):
        q, k, v = _operands(seed=1)
        ref = jax_da.flash_decode(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), 40, interpret=True
        )
        out = da.flash_decode(*(_t(x, torch.bfloat16) for x in (q, k, v)), 40)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(out.float().numpy(), _np(ref), rtol=2e-2, atol=2e-2)

    def test_int8_cache_dequantized_inside(self):
        q, k, v = _operands(T=32, seed=2)
        kq, ksc = jax_llama._quantize_kv(jnp.asarray(k, jnp.bfloat16))
        vq, vsc = jax_llama._quantize_kv(jnp.asarray(v, jnp.bfloat16))
        qb = jnp.asarray(q, jnp.bfloat16)
        ref = jax_da.flash_decode(qb, kq, vq, 20, k_scale=ksc, v_scale=vsc, interpret=True)
        out = da.flash_decode(
            _t(q, torch.bfloat16),
            torch.from_numpy(np.array(kq)),
            torch.from_numpy(np.array(vq)),
            20,
            k_scale=_t(_np(ksc), torch.bfloat16),
            v_scale=_t(_np(vsc), torch.bfloat16),
        )
        np.testing.assert_allclose(out.float().numpy(), _np(ref), rtol=2e-2, atol=2e-2)

    def test_zero_length_row_is_zero(self):
        # A cursor of 0 skips every block on the TPU: acc = l = 0, out = 0.
        q, k, v = _operands()
        lens = jnp.asarray([0, 5], jnp.int32)
        ref = jax_da.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lens, interpret=True)
        out = da.flash_decode(_t(q), _t(k), _t(v), torch.tensor([0, 5], dtype=torch.int32))
        assert not out[0].any()
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=2e-6, atol=2e-6)

    def test_any_cache_length(self):
        # The TPU kernel needs a tile dividing T; the port masks the tail
        # itself, so T = 37 agrees with the masked reference attention.
        from accelerate_tpu.models.layers import dot_product_attention

        q, k, v = _operands(T=37, seed=3)
        lens = np.array([37, 11])
        mask = np.arange(37)[None, :] < lens[:, None]
        ref = dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask))
        out = da.flash_decode(_t(q), _t(k), _t(v), torch.tensor(lens, dtype=torch.int32))
        np.testing.assert_allclose(out.numpy(), _np(ref), rtol=2e-6, atol=2e-6)


class TestWrapper:
    def test_cpu_runs_plain_version_and_counts_no_launch(self):
        q, k, v = _operands()
        before = da.KERNEL.launches
        out = da.flash_decode(_t(q), _t(k), _t(v), torch.tensor(7, dtype=torch.int32))
        ref = da.flash_decode_reference(_t(q), _t(k), _t(v), 7)
        assert torch.equal(out, ref)
        assert da.KERNEL.launches == before

    @pytest.mark.parametrize(
        "case",
        ["prefill", "gqa", "one-scale", "int8-no-scales", "lengths-int64", "lengths-shape"],
    )
    def test_rejects_what_the_kernel_does_not_take(self, case):
        q, k, v = (_t(x) for x in _operands())
        lens, kw = 8, {}
        if case == "prefill":
            q = torch.zeros(2, 3, 4, 16)
        elif case == "gqa":
            q = torch.zeros(2, 1, 3, 16)
        elif case == "one-scale":
            kw = {"k_scale": torch.ones(2, 64, 2, dtype=torch.bfloat16)}
        elif case == "int8-no-scales":
            k = v = torch.zeros(2, 64, 2, 16, dtype=torch.int8)
        elif case == "lengths-int64":
            lens = torch.tensor([1, 2])
        else:
            lens = torch.tensor([1, 2, 3], dtype=torch.int32)
        with pytest.raises(ValueError):
            da.flash_decode(q, k, v, lens, **kw)

    @pytest.mark.parametrize("B,K,T", [(8, 8, 512), (8, 8, 4096), (1, 1, 1), (3, 2, 37), (64, 8, 100)])
    def test_split_plan_covers_the_cache(self, B, K, T):
        n, chunk = da.split_plan(B, K, T, sms=132)
        assert n >= 1 and n * chunk >= T and (n - 1) * chunk < T
        assert chunk >= min(da._MIN_CHUNK, T)


class TestDispatch:
    def test_registry_and_launch_counts(self):
        kernel = dispatch.register_kernel("flash_decode")
        assert kernel is da.KERNEL  # get-or-create
        kernel.launches += 3
        assert dispatch.launch_counts()["flash_decode"] >= 3
        assert {"kernel", "doc", "launches"} <= set(dispatch.kernel_status()[0])
        dispatch.reset_launch_counts()
        assert dispatch.launch_counts()["flash_decode"] == 0


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


class TestBuild:
    def test_command_targets_sm90a(self):
        cmd = build.nvcc_command("nvcc", build.CSRC_DIR / "decode_attention.cu", build.BUILD_DIR / "x.so")
        joined = " ".join(cmd)
        assert "arch=compute_90a,code=sm_90a" in joined and "-shared" in cmd and "-O3" in cmd

    def test_library_name_follows_the_source(self, tmp_path):
        src = tmp_path / "k.cu"
        src.write_text("a")
        first = build.library_path(src, tmp_path)
        src.write_text("b")
        assert build.library_path(src, tmp_path) != first

    def test_missing_nvcc_raises(self, tmp_path, monkeypatch):
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build_all(tmp_path)

    def test_failed_build_raises_with_compiler_output(self, tmp_path):
        nvcc = _fake_nvcc(tmp_path, "echo 'error: boom'\nexit 2\n")
        with pytest.raises(RuntimeError, match="boom"):
            build.build_all(tmp_path / "out", nvcc=nvcc)
        assert not list((tmp_path / "out").glob("*.so"))

    def test_builds_once_then_reuses(self, tmp_path):
        calls = tmp_path / "calls"
        # Writes the file named after -o, and counts its invocations.
        nvcc = _fake_nvcc(
            tmp_path,
            f'echo x >> {calls}\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n',
        )
        out = build.build_all(tmp_path / "out", nvcc=nvcc)
        assert out["decode_attention"].exists()
        assert build.build_all(tmp_path / "out", nvcc=nvcc) == out
        assert len(calls.read_text().split()) == len(list(build.CSRC_DIR.glob("*.cu")))
        assert os.path.dirname(out["decode_attention"]) == str(tmp_path / "out")
