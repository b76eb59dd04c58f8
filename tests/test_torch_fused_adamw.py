"""Port of the fused-AdamW kernel's wrapper (`accelerate_tpu_torch.native.
fused_adamw`) and its plain version (`parallel.host_offload._adamw_slice`)
against the JAX package, on the CPU, from the same numpy inputs: JAX's
Pallas kernel `fused_adamw_update` in interpret mode, and its plain
`_adamw_slice` under ``force_kernels("off")``. The reference's
`TestFusedAdamW` (`tests/test_kernels.py`) translated case by case.

Tolerances: fp32 moments, JAX's own kernel-vs-slice tolerance (rtol 1e-6,
atol 1e-7): the same operations, in another order where XLA fuses them
(the port is bit-equal to JAX's plain body for mu and nu and within an ulp
for the update; JAX's interpret-mode kernel differs from its own body by
an ulp here and there). bf16 moments: one bf16 rounding (rtol 2^-8, atol
1e-7), because XLA may keep fp32 intermediates in a fused bf16 chain where
the port rounds after every op (measured bit-equal with jax 0.9).

On the CPU the wrapper runs the plain version and launches nothing; the
kernel itself runs only on the card (`chip_smoke.py`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.native.pallas import fused_adamw as jfused
from accelerate_tpu.native.pallas.dispatch import force_kernels
from accelerate_tpu.parallel import host_offload as jho
from accelerate_tpu_torch.native import dispatch
from accelerate_tpu_torch.native.fused_adamw import KERNEL, fused_adamw, update_scalars
from accelerate_tpu_torch.parallel import host_offload as tho

HP = (1e-3, 0.9, 0.999, 1e-8, 1e-4)  # lr, b1, b2, eps, weight decay
TOL = {torch.float32: dict(rtol=1e-6, atol=1e-7), torch.bfloat16: dict(rtol=2.0**-8, atol=1e-7)}
J = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _autotune_dir(monkeypatch, tmp_path):
    """JAX's kernel picks its block through the process-wide autotune
    cache; keep its writes in this test's directory."""
    monkeypatch.setenv("ATX_AUTOTUNE_DIR", str(tmp_path))


def _leaf(n, g_dtype=torch.float32, m_dtype=torch.float32, seed=10):
    """(g, mu, nu, p) as numpy fp32 values already rounded to their dtypes."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(n) * 1e-2, rng.standard_normal(n) * 1e-3,
              np.abs(rng.standard_normal(n)) * 1e-6, rng.standard_normal(n)]
    dtypes = (g_dtype, m_dtype, m_dtype, torch.float32)
    return [torch.from_numpy(a.astype(np.float32)).to(d).float().numpy() for a, d in zip(arrays, dtypes)]


def _port(leaf, g_dtype, m_dtype, count, scale, apply=False):
    g, mu, nu, p = (torch.from_numpy(a.copy()) for a in leaf)
    g, mu, nu = g.to(g_dtype), mu.to(m_dtype), nu.to(m_dtype)
    s = None if scale is None else torch.tensor([scale])
    u, mu2, nu2 = fused_adamw(g, mu, nu, p, count, *HP, s, apply=apply)
    return (p if apply else u), mu2, nu2


def _jax_args(leaf, g_dtype, m_dtype, count):
    g, mu, nu, p = leaf
    return (jnp.asarray(g).astype(J[g_dtype]), jnp.asarray(mu).astype(J[m_dtype]),
            jnp.asarray(nu).astype(J[m_dtype]), jnp.asarray(p), jnp.asarray(float(count)), *HP)


def _close(got, want, m_dtype, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(jnp.asarray(want, jnp.float32)),
                               err_msg=what, **TOL[m_dtype])


class TestFusedAdamW:
    @pytest.mark.parametrize("count", [1, 7])
    @pytest.mark.parametrize("m_dtype", [torch.float32, torch.bfloat16], ids=["mu_fp32", "mu_bf16"])
    @pytest.mark.parametrize("with_scale", [False, True])
    @pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16], ids=["g_fp32", "g_bf16"])
    def test_parity_vs_jax_kernel_and_adamw_slice(self, g_dtype, with_scale, m_dtype, count):
        leaf = _leaf(2048, g_dtype, m_dtype)
        scale = 0.5 if with_scale else None
        args = _jax_args(leaf, g_dtype, m_dtype, count)
        jscale = None if scale is None else jnp.asarray(scale)
        kernel = jfused.fused_adamw_update(*args, jscale, interpret=True)
        assert kernel is not None
        with force_kernels("off"):
            plain = jho._adamw_slice(*args, grad_scale=jscale)
        got = _port(leaf, g_dtype, m_dtype, count, scale)
        for name, a, k, b in zip(("update", "mu", "nu"), got, kernel, plain):
            assert a.dtype == m_dtype
            _close(a, k, m_dtype, f"{name} vs the interpret-mode kernel")
            _close(a, b, m_dtype, f"{name} vs _adamw_slice")

    def test_tiny_leaf_takes_the_kernel_path_with_adamw_slice_numbers(self):
        """JAX's kernel refuses a 24-element leaf (a TPU tiling rule) and
        falls back; the port's wrapper takes every leaf, with the numbers
        of JAX's `_adamw_slice`."""
        leaf = _leaf(24)
        args = _jax_args(leaf, torch.float32, torch.float32, 1)
        assert jfused.fused_adamw_update(*args) is None
        with force_kernels("off"):
            plain = jho._adamw_slice(*args)
        for name, a, b in zip(("update", "mu", "nu"), _port(leaf, torch.float32, torch.float32, 1, None), plain):
            _close(a, b, torch.float32, name)

    @pytest.mark.parametrize("n", [1, 3, 4097, 100_003])
    def test_ragged_sizes_match_adamw_slice(self, n):
        leaf = _leaf(n, seed=n)
        args = _jax_args(leaf, torch.float32, torch.float32, 3)
        with force_kernels("off"):
            plain = jho._adamw_slice(*args, grad_scale=jnp.asarray(0.25))
        for name, a, b in zip(("update", "mu", "nu"), _port(leaf, torch.float32, torch.float32, 3, 0.25), plain):
            _close(a, b, torch.float32, name)

    def test_adamw_slice_dispatches_under_interpret_and_matches_the_port(self):
        """JAX's `_adamw_slice` through its kernel (interpret mode) and the
        port's plain `_adamw_slice` agree; the port's wrapper on CPU
        tensors equals its plain version bit for bit, and launches
        nothing."""
        leaf = _leaf(4096)
        args = _jax_args(leaf, torch.float32, torch.float32, 3)
        with force_kernels("interpret"):
            kernel = jho._adamw_slice(*args)
        g, mu, nu, p = (torch.from_numpy(a.copy()) for a in leaf)
        plain = tho._adamw_slice(g, mu, nu, p, 3, *HP)
        for name, a, k in zip(("update", "mu", "nu"), plain, kernel):
            _close(a, k, torch.float32, name)
        before = KERNEL.launches
        got = _port(leaf, torch.float32, torch.float32, 3, None)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
        assert KERNEL.launches == before
        assert dispatch.launch_counts()["fused_adamw"] == before


class TestWrapper:
    @pytest.mark.parametrize("m_dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
    def test_apply_adds_the_update_into_p(self, m_dtype, p_dtype):
        def operands():
            g, mu, nu, p = (torch.from_numpy(a.copy()) for a in _leaf(1000, m_dtype=m_dtype))
            return g, mu.to(m_dtype), nu.to(m_dtype), p.to(p_dtype)

        g, mu, nu, p = operands()
        u, mu_u, nu_u = fused_adamw(g, mu, nu, p, 2, *HP, torch.tensor(0.5))
        want = p + u  # apply_updates: p + u in the promoted type, cast to p's
        g, mu, nu, p = operands()
        out, mu2, nu2 = fused_adamw(g, mu, nu, p, 2, *HP, torch.tensor(0.5), apply=True)
        assert out is None and p.dtype == p_dtype
        assert torch.equal(p, want.to(p_dtype))
        assert torch.equal(mu2, mu_u) and torch.equal(nu2, nu_u)

    def test_moments_update_in_place(self):
        g, mu, nu, p = (torch.from_numpy(a.copy()) for a in _leaf(64))
        ptrs = (mu.data_ptr(), nu.data_ptr())
        _, mu2, nu2 = fused_adamw(g, mu, nu, p, 1, *HP)
        assert (mu2.data_ptr(), nu2.data_ptr()) == ptrs and mu2 is mu and nu2 is nu
        assert not torch.equal(mu, torch.from_numpy(_leaf(64)[1]))

    def test_rejects_what_the_kernel_does_not_take(self):
        g, mu, nu, p = (torch.from_numpy(a.copy()) for a in _leaf(8))
        with pytest.raises(ValueError, match="one shape"):
            fused_adamw(g[:4], mu, nu, p, 1, *HP)
        with pytest.raises(ValueError, match="dtype"):
            fused_adamw(g.half(), mu, nu, p, 1, *HP)
        with pytest.raises(ValueError, match="share a dtype"):
            fused_adamw(g, mu, nu.bfloat16(), p, 1, *HP)
        with pytest.raises(ValueError, match="grad_scale"):
            fused_adamw(g, mu, nu, p, 1, *HP, torch.ones(2))

    @pytest.mark.parametrize("count", [1, 7, 1000])
    def test_scalars_take_the_moment_dtype(self, count):
        """JAX's weak-typed scalars take the moment dtype (with bf16
        moments b1 = 0.9 becomes 0.8984375), and its bias correction
        ``1 - b^c`` is computed in that dtype from the count cast to it."""
        for dt in (torch.float32, torch.bfloat16):
            s = update_scalars(count, 1e-3, 0.9, 0.999, 1e-8, 1e-4, dt)
            c = jnp.asarray(count, jnp.int32).astype(J[dt])
            assert s.b1 == float(jnp.asarray(0.9, J[dt]))
            assert s.one_minus_b2 == float(jnp.asarray(1.0 - 0.999, J[dt]))
            assert s.bias_correction1 == float(1.0 - 0.9**c)
            assert s.bias_correction2 == float(1.0 - 0.999**c)
            assert s.neg_lr == float(jnp.asarray(-1e-3, J[dt]))
        assert update_scalars(1, 1e-3, 0.9, 0.999, 1e-8, 1e-4, torch.bfloat16).b1 == 0.8984375
