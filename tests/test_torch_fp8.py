"""Port fp8 compute (`accelerate_tpu_torch.ops.fp8`, the fp8 half of
`native.quant_matmul`, and the routing of `models.layers`) against the JAX
package's `ops/fp8.py` and `native/pallas/quant_matmul.py`, on the CPU,
from the same numpy inputs.

Tolerances:
- `quantize`: bit-equal (uint8 views of the fp8 values; the scale too).
- fp8 products in fp32: 1e-5 relative to the largest output. The fp8
  operands are bit-equal and their products exact in fp32; the sums run in
  another order.
- in bf16: one bf16 rounding on top (2^-7 relative).
- The layer tests count calls and compare op lists: exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from accelerate_tpu.native.pallas import quant_matmul as jqm
from accelerate_tpu.native.pallas.dispatch import force_kernels
from accelerate_tpu.ops import fp8 as jfp8
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch.models import layers, llama
from accelerate_tpu_torch.native import dispatch
from accelerate_tpu_torch.native import quant_matmul as qm
from accelerate_tpu_torch.ops import fp8 as tfp8

PROJECTION_EQS = [
    ("bsd,dhk->bshk", (2, 8, 32), (32, 4, 8)),
    ("bshk,hkd->bsd", (2, 8, 4, 8), (4, 8, 32)),
    ("bsd,df->bsf", (2, 8, 32), (32, 64)),
    ("bsf,fd->bsd", (2, 8, 64), (64, 32)),
]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
FP8 = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn), "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _pair(a: np.ndarray, dtype: str):
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(a):
    if isinstance(a, jax.Array):
        return np.asarray(jnp.asarray(a, jnp.float32))
    return a.detach().float().numpy()


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    scale = np.abs(want).max()
    rtol = 2.0**-7 if dtype == "bf16" else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-5 * scale)


class TestQuantize:
    @pytest.mark.parametrize("fp8", ["e4m3", "e5m2"])
    @pytest.mark.parametrize("dtype", ["fp32", "bf16"])
    @pytest.mark.parametrize("spread", [1.0, 1e-3, 0.0], ids=["unit", "small", "zeros"])
    def test_bit_equal(self, fp8, dtype, spread):
        x = np.random.default_rng(0).standard_normal((6, 40)).astype(np.float32) * spread
        x[0, 0] = 50.0 * spread  # the amax
        jx, tx = _pair(x, dtype)
        jqv, js = jfp8.quantize(jx, FP8[fp8][0])
        tqv, ts = tfp8.quantize(tx, FP8[fp8][1])
        assert tqv.dtype == FP8[fp8][1] and ts.dtype == torch.float32 and ts.ndim == 0
        np.testing.assert_array_equal(tqv.view(torch.uint8).numpy(), np.asarray(jqv).view(np.uint8))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    def test_leaves_the_input_alone(self):
        x = torch.randn(4, 8)
        before = x.clone()
        tfp8.quantize(x)
        assert torch.equal(x, before)


class TestFp8Einsum:
    @pytest.mark.parametrize("eq,xs,ws", PROJECTION_EQS, ids=[e[0] for e in PROJECTION_EQS])
    @pytest.mark.parametrize("dtype", ["fp32", "bf16"])
    def test_forward_and_backward_match_jax_vjp(self, eq, xs, ws, dtype):
        rng = np.random.default_rng(1)
        x = rng.standard_normal(xs).astype(np.float32)
        w = (rng.standard_normal(ws) * 0.2).astype(np.float32)
        out_shape = np.einsum(eq, x, w).shape
        g = rng.standard_normal(out_shape).astype(np.float32)
        (jx, tx), (jw, tw), (jg, tg) = _pair(x, dtype), _pair(w, dtype), _pair(g, dtype)
        with force_kernels("off"):
            want, vjp = jax.vjp(lambda a, b: jfp8.fp8_einsum(eq, a, b), jx, jw)
            want_dx, want_dw = vjp(jg)
        tx.requires_grad_()
        tw.requires_grad_()
        got = tfp8.fp8_einsum(eq, tx, tw)
        got.backward(tg)
        assert got.dtype == tx.dtype and tx.grad.dtype == tx.dtype and tw.grad.dtype == tw.dtype
        _close(got, want, dtype)
        _close(tx.grad, want_dx, dtype)
        _close(tw.grad, want_dw, dtype)

    @pytest.mark.parametrize("eq", [e[0] for e in PROJECTION_EQS] + ["ij,jk->ik", "ki,kj->ij"])
    def test_grad_equations_match_jax(self, eq):
        assert tfp8._grad_equations(eq) == jfp8._grad_equations(eq)

    def test_mixed_primal_dtypes(self):
        """dx and dw come back in their own primal dtypes."""
        x = torch.randn(2, 3, 8, dtype=torch.bfloat16, requires_grad=True)
        w = torch.randn(8, 4, requires_grad=True)
        tfp8.fp8_einsum("bsd,df->bsf", x, w).float().sum().backward()
        assert x.grad.dtype == torch.bfloat16 and w.grad.dtype == torch.float32


class TestScaledMatmul:
    CASES = [
        ("ij,jk->ik", (32, 64), (64, 16)),   # trail x lead
        ("ki,kj->ij", (64, 32), (64, 16)),   # lead x lead
        ("ik,jk->ij", (32, 64), (16, 64)),   # trail x trail
        ("ki,jk->ij", (64, 32), (16, 64)),   # lead x trail
    ]

    @pytest.mark.parametrize("eq,ashape,bshape", CASES, ids=[c[0] for c in CASES])
    @pytest.mark.parametrize("types", [("e4m3", "e4m3"), ("e5m2", "e4m3"), ("e4m3", "e5m2")])
    @pytest.mark.parametrize("out", ["fp32", "bf16"])
    def test_plain_version_matches_jax_interpret(self, eq, ashape, bshape, types, out, monkeypatch, tmp_path):
        monkeypatch.setenv("ATX_AUTOTUNE_DIR", str(tmp_path))
        rng = np.random.default_rng(2)
        a = rng.standard_normal(ashape).astype(np.float32)
        b = rng.standard_normal(bshape).astype(np.float32)
        ja, jb = jnp.asarray(a).astype(FP8[types[0]][0]), jnp.asarray(b).astype(FP8[types[1]][0])
        ta = torch.from_numpy(np.asarray(ja).view(np.uint8).copy()).view(FP8[types[0]][1])
        tb = torch.from_numpy(np.asarray(jb).view(np.uint8).copy()).view(FP8[types[1]][1])
        jd, td = DTYPES[out]
        want = jqm.scaled_matmul(eq, ja, jb, jnp.float32(0.37), jd, interpret=True)
        scale = torch.tensor(0.37)
        got = qm.scaled_matmul_reference(eq, ta, tb, scale, td)
        assert got.dtype == td
        _close(got, want, out)
        before = dispatch.launch_counts().get("fp8_matmul", 0)
        assert torch.equal(qm.scaled_matmul(eq, ta, tb, scale, td), got)  # the CPU: the plain version
        assert dispatch.launch_counts()["fp8_matmul"] == before


class TestMatmulEinsum:
    EQ, XS, WS = PROJECTION_EQS[2]

    def _inputs(self):
        rng = np.random.default_rng(3)
        return rng.standard_normal(self.XS).astype(np.float32), rng.standard_normal(self.WS).astype(np.float32)

    def test_plain_outside_the_modes(self):
        x, w = self._inputs()
        want = jfp8.matmul_einsum(self.EQ, jnp.asarray(x), jnp.asarray(w))
        got = tfp8.matmul_einsum(self.EQ, torch.from_numpy(x), torch.from_numpy(w))
        _close(got, want, "fp32")
        assert tfp8.fp8_hits() == 0

    def test_fp8_inside_the_mode_counts_hits(self):
        x, w = self._inputs()
        with force_kernels("off"), jfp8.fp8_matmuls():
            want = jfp8.matmul_einsum(self.EQ, jnp.asarray(x), jnp.asarray(w))
        with tfp8.fp8_matmuls():
            got = tfp8.matmul_einsum(self.EQ, torch.from_numpy(x), torch.from_numpy(w))
            tfp8.matmul_einsum(self.EQ, torch.from_numpy(x), torch.from_numpy(w))
            assert tfp8.fp8_enabled() and tfp8.fp8_hits() == 2
            with tfp8.fp8_matmuls(False):
                assert not tfp8.fp8_enabled() and tfp8.fp8_hits() == 0
            assert tfp8.fp8_hits() == 2
        assert not tfp8.fp8_enabled() and tfp8.fp8_hits() == 0
        _close(got, want, "fp32")
        plain = torch.from_numpy(x) @ torch.from_numpy(w)
        assert not torch.allclose(got, plain, rtol=1e-4)  # really quantized

    def test_fp8_dequantizes_a_quantized_node_first(self):
        """fp8 wins over int8 compute, as in JAX."""
        from accelerate_tpu.ops import int8 as jint8
        from accelerate_tpu_torch.ops import int8 as tint8

        x, w = self._inputs()
        node = jq.quantize_array(jnp.asarray(w))
        tnode = {k: torch.from_numpy(np.array(v)) for k, v in node.items()}
        with force_kernels("off"), jfp8.fp8_matmuls(), jint8.int8_compute():
            want = jfp8.matmul_einsum(self.EQ, jnp.asarray(x), node)
        with tfp8.fp8_matmuls(), tint8.int8_compute():
            got = tfp8.matmul_einsum(self.EQ, torch.from_numpy(x), tnode)
        _close(got, want, "fp32")


# ------------------------------------------------------------------ layers
def _old_project(x, w):
    out = x @ w.reshape(w.shape[0], -1).to(x.dtype)
    return out.view(*x.shape[:-1], *w.shape[1:])


def _old_attention_out(params, attn):
    wo = params["wo"]
    return attn.reshape(*attn.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1]).to(attn.dtype)


def _old_swiglu(params, x):
    gate = x @ params["w_gate"].to(x.dtype)
    up = x @ params["w_up"].to(x.dtype)
    return (F.silu(gate) * up) @ params["w_down"].to(x.dtype)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        dtypes = tuple(str(a.dtype) for a in args if isinstance(a, torch.Tensor))
        self.ops.append((str(func), dtypes))
        return func(*args, **(kwargs or {}))


def _block_inputs(cfg, dtype=torch.bfloat16, seed=0):
    params = llama.init(cfg, seed=seed, dtype=dtype, device="cpu")
    block = llama.nest({k: v[0].detach().requires_grad_() for k, v in llama.flatten(params["blocks"]).items()})
    B, S = 2, 16
    x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(seed)).to(dtype).requires_grad_()
    cos, sin = llama._rope_tables(cfg, x.device)
    kw = dict(config=cfg, cos=cos, sin=sin, positions=torch.arange(S)[None, :].expand(B, S), mask=None)
    return params, block, x, kw


def _train_block_ops(cfg):
    _, block, x, kw = _block_inputs(cfg)
    with _Ops() as rec:
        llama.block_forward(block, x, **kw).float().sum().backward()
    return rec.ops


def _decode_ops(cfg):
    params, _, _, _ = _block_inputs(cfg)
    cache = llama.init_cache(cfg, 2, 16, torch.bfloat16, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 4), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        _, cache = llama.forward_with_cache(params, tokens, cache, cfg)
        with _Ops() as rec:
            llama.forward_with_cache(params, tokens[:, :1], cache, cfg)
    return rec.ops


class TestNoCostOutsideModes:
    """With neither fp8 nor int8 on, the bf16 paths issue the same aten ops
    as the pre-routing layers (plain ``x @ w``, no einsum, no extra op)."""

    @pytest.mark.parametrize("run", [_train_block_ops, _decode_ops], ids=["train_block", "decode_step"])
    @pytest.mark.parametrize("policy", ["attn_and_outputs", "nothing"])
    def test_same_aten_ops_as_before_the_routing(self, run, policy, monkeypatch):
        cfg = llama.LlamaConfig.tiny(remat=True, remat_policy=policy)
        now = run(cfg)
        monkeypatch.setattr(layers, "_project", _old_project)
        for mod in (layers, llama):
            monkeypatch.setattr(mod, "attention_out", _old_attention_out)
            monkeypatch.setattr(mod, "swiglu", _old_swiglu)
        before = run(cfg)
        assert now == before
        assert not any("einsum" in op or "float8" in str(d) for op, d in now)


class TestFp8Layers:
    def _count(self, monkeypatch):
        calls = []

        def counting(eq, qa, qb, scale, out_dtype):
            calls.append(eq)
            return qm.scaled_matmul(eq, qa, qb, scale, out_dtype)

        monkeypatch.setattr(layers, "scaled_matmul", counting)
        monkeypatch.setattr(tfp8, "scaled_matmul", counting)
        return calls

    @pytest.mark.parametrize(
        "policy,recomputed",
        [("attn_and_outputs", 4), ("block_outputs", 7), ("nothing", 7), (None, 0)],
        ids=["attn_and_outputs", "block_outputs", "nothing", "no_remat"],
    )
    def test_every_product_of_a_block_is_fp8(self, policy, recomputed, monkeypatch):
        """Forward 7 fp8 products, backward 14 (dx and dw), plus the forward
        products of the segments the policy recomputes: the output
        projection and the MLP's three under ``attn_and_outputs`` (q/k/v are
        kept), all seven under the others. No bf16 matmul is left."""
        calls = self._count(monkeypatch)
        cfg = llama.LlamaConfig.tiny(remat=policy is not None, remat_policy=policy or "nothing")
        _, block, x, kw = _block_inputs(cfg)
        with tfp8.fp8_matmuls():
            out = llama.block_forward(block, x, **kw)
            assert len(calls) == 7 and tfp8.fp8_hits() == 7
        with _Ops() as rec:
            out.float().sum().backward()  # outside the context: the mode was captured
        assert len(calls) == 7 + 14 + recomputed
        mms = [d for op, d in rec.ops if op.startswith("aten.mm") or op.startswith("aten.addmm")]
        assert all(d == ("torch.float32", "torch.float32") for d in mms), mms

    def test_dots_policy_raises_under_fp8(self):
        cfg = llama.LlamaConfig.tiny(remat=True, remat_policy="dots")
        _, block, x, kw = _block_inputs(cfg)
        with tfp8.fp8_matmuls(), pytest.raises(NotImplementedError, match="dots"):
            llama.block_forward(block, x, **kw)
