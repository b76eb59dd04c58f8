"""Port flash attention (`accelerate_tpu_torch.ops.flash_attention` and the
plain versions in `accelerate_tpu_torch.native.flash_attention`) against the
JAX package's Pallas kernels, run in interpret mode as its own tests run
them (`flash_attention(..., block_size=..., interpret=True)`, whose custom
VJP gives the JAX backward); plus the routing, the wrappers' checks and the
launch counters.

The CUDA kernels cannot run here: `chip_smoke.py` holds them against the
plain versions on the card. On CPU tensors the wrappers ARE the plain
versions, so these tests pin the functions the kernels must compute.

Tolerances: fp32 forward 2e-5 and gradients 5e-4 (the JAX kernel tests'
own: fp32 on both sides, sums in another order and, in JAX, an online
softmax over blocks); bf16 2e-2 (each side rounds p, ds and the outputs to
bf16, at other points of the online softmax, ~4e-3 relative each).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models.layers import dot_product_attention as jax_dpa
from accelerate_tpu.ops import flash_attention as jax_fa
from accelerate_tpu_torch.models import layers
from accelerate_tpu_torch.native import dispatch
from accelerate_tpu_torch.native import flash_attention as fa
from accelerate_tpu_torch.ops import flash_attention as ops_fa
from accelerate_tpu_torch.ops.flash_attention import flash_attention

TOL = {"fp32": (2e-5, 5e-4), "bf16": (2e-2, 2e-2)}
JDT = {"fp32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _autotune_dir(tmp_path, monkeypatch):
    # The JAX entry point banks its block choice in the autotune table.
    monkeypatch.setenv("ATX_AUTOTUNE_DIR", str(tmp_path))


def _operands(B=2, S=64, H=4, K=2, h=16, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, h), dtype=np.float32)
    k = rng.standard_normal((B, S, K, h), dtype=np.float32)
    v = rng.standard_normal((B, S, K, h), dtype=np.float32)
    w = rng.standard_normal((B, S, H, h), dtype=np.float32)
    return q, k, v, w


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _leaf(x, dtype):
    return torch.from_numpy(x).to(TDT[dtype]).requires_grad_()


def _jax_out_and_grads(q, k, v, w, dtype, **kw):
    jq, jk, jv = (jnp.asarray(x, JDT[dtype]) for x in (q, k, v))
    out, vjp = jax.vjp(lambda q, k, v: jax_fa.flash_attention(q, k, v, interpret=True, **kw), jq, jk, jv)
    return out, vjp(jnp.asarray(w, JDT[dtype]))


def _torch_out_and_grads(q, k, v, w, dtype, **kw):
    tq, tk, tv = (_leaf(x, dtype) for x in (q, k, v))
    out = flash_attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(w).to(TDT[dtype]))
    return out, (tq.grad, tk.grad, tv.grad)


def _assert_close(got, want, tol, what):
    np.testing.assert_allclose(got.detach().float().numpy(), _np(want), atol=tol, rtol=tol, err_msg=what)


class TestMatchesJaxKernels:
    @pytest.mark.parametrize(
        "dtype,shape,kw",
        [
            (dtype, shape, kw)
            for shape, kw, dtypes in [
                (dict(H=4, K=2), dict(causal=True), ("fp32", "bf16")),
                (dict(H=4, K=2), dict(causal=False), ("fp32",)),
                (dict(H=4, K=4), dict(causal=True), ("fp32",)),
                (dict(S=100, H=4, K=1), dict(causal=True), ("fp32", "bf16")),
                (dict(S=100, H=4, K=2), dict(causal=False), ("fp32", "bf16")),
                (dict(S=96, H=4, K=2), dict(causal=True, window=24), ("fp32", "bf16")),
            ]
            for dtype in dtypes
        ],
        ids=["causal-gqa-fp32", "causal-gqa-bf16", "noncausal-gqa-fp32", "causal-mha-fp32",
             "ragged-S100-mqa-fp32", "ragged-S100-mqa-bf16", "ragged-S100-noncausal-fp32",
             "ragged-S100-noncausal-bf16", "window24-fp32", "window24-bf16"],
    )
    def test_forward_and_gradients(self, dtype, shape, kw):
        """JAX pads S=100 to its 32-block and slices; the port masks."""
        q, k, v, w = _operands(**shape)
        jout, jgrads = _jax_out_and_grads(q, k, v, w, dtype, block_size=32, **kw)
        tout, tgrads = _torch_out_and_grads(q, k, v, w, dtype, **kw)
        fwd_tol, grad_tol = TOL[dtype]
        _assert_close(tout, jout, fwd_tol, "out")
        for name, got, want in zip("qkv", tgrads, jgrads):
            assert got.dtype == TDT[dtype]
            _assert_close(got, want, grad_tol, f"d{name}")

    @pytest.mark.parametrize("causal", [True, False])
    def test_kernel_functions_with_valid_prefix(self, causal):
        """The kernels' ``valid`` argument (non-causal: columns >= valid are
        masked; the JAX entry point passes S, ring attention its chunk's
        length) against the JAX custom VJP called with the same ``valid``."""
        q, k, v, w = _operands(S=64)
        valid = 57
        tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
        scale = 1.0 / np.sqrt(q.shape[-1])

        def f(q, k, v):
            return jax_fa._flash(q, k, v, scale, 32, causal, True, valid, None)

        jout, vjp = jax.vjp(f, tr(q), tr(k), tr(v))
        jdq, jdk, jdv = (x.transpose(0, 2, 1, 3) for x in vjp(tr(w)))
        tq, tk, tv, tw = (torch.from_numpy(x) for x in (q, k, v, w))
        o, lse = fa.flash_attention_fwd(tq, tk, tv, causal=causal, valid=valid)
        dq, dk, dv = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tw, causal=causal, valid=valid)
        _assert_close(o, jout.transpose(0, 2, 1, 3), 2e-5, "out")
        for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
            _assert_close(got, want, 5e-4, name)
        if not causal:
            assert not dk[:, valid:].any() and not dv[:, valid:].any()

    def test_lse_matches_jax_forward_residual(self):
        q, k, v, _ = _operands()
        tr = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)  # noqa: E731
        _, jlse = jax_fa._fwd(tr(q), tr(k), tr(v), scale=0.25, block=32, causal=True, interpret=True,
                              valid=64)
        _, lse = fa.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), scale=0.25)
        np.testing.assert_allclose(lse.numpy(), _np(jlse)[..., 0], atol=2e-5, rtol=2e-5)


class TestPlainBackward:
    @pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False, valid=50),
                                    dict(causal=True, window=9)], ids=["causal", "valid", "window"])
    def test_equals_autograd_of_the_plain_forward(self, kw):
        """In fp32 the TPU kernels' backward formula is the exact gradient."""
        q, k, v, w = _operands(S=64, H=4, K=2)
        tq, tk, tv = (_leaf(x, "fp32") for x in (q, k, v))
        tw = torch.from_numpy(w)
        o, _ = fa.flash_attention_fwd_reference(tq, tk, tv, **kw)
        o.backward(tw)
        with torch.no_grad():
            o2, lse = fa.flash_attention_fwd_reference(tq, tk, tv, **kw)
            grads = fa.flash_attention_bwd_reference(tq, tk, tv, o2, lse, tw, **kw)
        for name, got, leaf in zip("qkv", grads, (tq, tk, tv)):
            np.testing.assert_allclose(got.numpy(), leaf.grad.numpy(), atol=1e-5, rtol=1e-5, err_msg=name)


class TestRouting:
    """Shapes outside the kernels' territory go to the plain attention, as
    in JAX (`ops/flash_attention.py:877-898`)."""

    @pytest.fixture
    def no_kernels(self, monkeypatch):
        def refuse(*args, **kwargs):
            raise AssertionError("routed to the kernels")

        monkeypatch.setattr(ops_fa, "flash_attention_fwd", refuse)

    def test_padding_mask(self, no_kernels):
        q, k, v, _ = _operands(S=32)
        mask = np.ones((2, 32), bool)
        mask[:, 20:] = False
        want = jax_dpa(*(jnp.asarray(x) for x in (q, k, v)), mask=jnp.asarray(mask), causal=True)
        got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), segment_mask=torch.from_numpy(mask))
        _assert_close(got, want, 2e-5, "masked")

    def test_short_sequence(self, no_kernels):
        q, k, v, _ = _operands(S=8)
        want = jax_fa.flash_attention(*(jnp.asarray(x) for x in (q, k, v)), interpret=True)
        _assert_close(flash_attention(*(torch.from_numpy(x) for x in (q, k, v))), want, 2e-5, "S<16")

    def test_decode_shape_with_window(self, no_kernels):
        """S != T: queries are the last S of T positions; the window band is
        folded into the mask."""
        q, _, _, _ = _operands(S=4)
        _, k, v, _ = _operands(S=40)
        jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
        want = jax_fa.flash_attention(jq, jk, jv, causal=True, window=16, interpret=True)
        got = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), causal=True, window=16)
        _assert_close(got, want, 2e-5, "S!=T window")

    def test_kernel_route_counts_no_launch_on_cpu(self):
        q, k, v, _ = _operands(S=32)
        before = dispatch.launch_counts()
        out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)))
        assert out.shape == (2, 32, 4, 16)
        after = dispatch.launch_counts()
        for name in ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"):
            assert after[name] == before[name]

    def test_uneven_groups_raise(self):
        q = torch.zeros(1, 32, 3, 16)
        k = torch.zeros(1, 32, 2, 16)
        with pytest.raises(ValueError, match="divisible"):
            flash_attention(q, k, k)


class TestWrappers:
    def test_registered_with_counters(self):
        names = {s["kernel"] for s in dispatch.kernel_status()}
        assert {"flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv"} <= names
        assert dispatch.register_kernel("flash_attention_dq") is fa.DQ_KERNEL

    @pytest.mark.parametrize(
        "case", ["k-length", "head-dim", "heads", "lse-shape", "window", "valid"]
    )
    def test_rejects_bad_operands(self, case):
        q, k, v, w = (torch.from_numpy(x) for x in _operands(S=32))
        lse = torch.zeros(2, 4, 32)
        kw = {}
        if case == "k-length":
            k = v = torch.zeros(2, 31, 2, 16)
        elif case == "head-dim":
            k = v = torch.zeros(2, 32, 2, 8)
        elif case == "heads":
            k = v = torch.zeros(2, 32, 3, 16)
        elif case == "lse-shape":
            lse = torch.zeros(2, 32, 4)
        elif case == "window":
            kw = {"window": 0}
        else:
            kw = {"causal": False, "valid": 33}
        with pytest.raises(ValueError):
            fa.flash_attention_fwd(q, k, v, **kw)
            fa.flash_attention_dq(q, k, v, w, lse, lse, **kw)

    def test_non_cuda_device_raises(self):
        q = torch.zeros(1, 32, 2, 128, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            fa.flash_attention_fwd(q, q, q)

    def test_kernel_source_is_built(self):
        from accelerate_tpu_torch.native import build

        assert (build.CSRC_DIR / "flash_attention.cu").is_file()
        src = (build.CSRC_DIR / "flash_attention.cu").read_text()
        for entry in ("atx_flash_attention_fwd", "atx_flash_attention_dq", "atx_flash_attention_dkv"):
            assert f'extern "C" int {entry}(' in src


def test_layers_dot_product_attention_is_the_route_target():
    """The routed-to function is the port's plain attention itself."""
    assert ops_fa.flash_attention.__module__ == "accelerate_tpu_torch.ops.flash_attention"
    q, k, v, _ = (torch.from_numpy(x) for x in _operands(S=8))
    torch.testing.assert_close(flash_attention(q, k, v), layers.dot_product_attention(q, k, v, causal=True))
