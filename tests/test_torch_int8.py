"""Port int8 compute (`accelerate_tpu_torch.ops.int8` and the int8 half of
`native.quant_matmul`) against the JAX package's `ops/int8.py`, on the CPU,
from the same numpy inputs.

The JAX side runs its fallback (the Pallas kernel is off on the CPU, and
`force_kernels("off")` pins it). Tolerances:
- `quantize_act`: bit-equal (same fp32 amax, division, half-even rounding).
- `int8_einsum`: bit-equal in fp32 and bf16. Integer accumulation is exact
  on both sides and the rescale is the same two fp32 products,
  ``acc * (x scale * w scale)``, rounded once to x's dtype.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.native.pallas import quant_matmul as jqm
from accelerate_tpu.native.pallas.dispatch import force_kernels
from accelerate_tpu.ops import fp8 as jfp8
from accelerate_tpu.ops import int8 as jint8
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch.native import dispatch
from accelerate_tpu_torch.native import quant_matmul as qm
from accelerate_tpu_torch.ops import fp8 as tfp8
from accelerate_tpu_torch.ops import int8 as tint8
from accelerate_tpu_torch.utils import quantization as tq

# The dense projection equations of the model zoo (the JAX test's
# MODEL_EQS; its MoE "ecd,edf->ecf" waits for the MoE blocks), with the
# stack_dims that test quantizes them with: 0, so q/k/v get the per-h scale
# (1, 1, h) of the stacked layout.
MODEL_EQS = [
    ("bsd,dhk->bshk", (2, 8, 32), (32, 4, 8)),
    ("bshk,hkd->bsd", (2, 8, 4, 8), (4, 8, 32)),
    ("bsd,df->bsf", (2, 8, 32), (32, 64)),
    ("bsf,fd->bsd", (2, 8, 64), (64, 32)),
]
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(xs, ws, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    x[0, 0] *= 20.0  # one outlier row
    w = rng.standard_normal(ws).astype(np.float32)
    jd, td = DTYPES[dtype]
    jx = jnp.asarray(x, jd)
    tx = torch.from_numpy(x).to(td)
    return jx, tx, w


def _to_np(a):
    return np.asarray(jnp.asarray(a, jnp.float32)) if isinstance(a, jax.Array) else a.float().numpy()


def _node_to_torch(node):
    return {k: torch.from_numpy(np.array(v)) for k, v in node.items()}


class TestQuantizeAct:
    @pytest.mark.parametrize("axes", [None, (2,), (2, 3), (0, 1)], ids=str)
    @pytest.mark.parametrize("dtype", ["fp32", "bf16"])
    def test_bit_equal(self, axes, dtype):
        jx, tx, _ = _inputs((2, 5, 4, 8), (1,), dtype)
        jq_, js = jint8.quantize_act(jx, axes)
        tq_, ts = tint8.quantize_act(tx, axes)
        assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


class TestInt8Einsum:
    @pytest.mark.parametrize("eq,xs,ws", MODEL_EQS, ids=[e[0] for e in MODEL_EQS])
    @pytest.mark.parametrize("dtype", ["fp32", "bf16"])
    @pytest.mark.parametrize("bits", [8, 4])
    def test_matches_jax_fallback(self, eq, xs, ws, dtype, bits):
        jx, tx, w = _inputs(xs, ws, dtype, seed=1)
        node = jq.quantize_array(jnp.asarray(w), stack_dims=0, bits=bits)
        with force_kernels("off"):
            want = jint8.int8_einsum_quantized(eq, jx, node)
        got = tint8.int8_einsum_quantized(eq, tx, _node_to_torch(node))
        assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_to_np(got), _to_np(want))

    def test_plain_kernel_version_is_the_wrapper_on_the_cpu(self):
        eq, xs, ws = MODEL_EQS[0]
        _, tx, w = _inputs(xs, ws, "bf16", seed=2)
        node = tq.quantize_array(torch.from_numpy(w), stack_dims=0)
        before = dispatch.launch_counts().get("int8_matmul", 0)
        via_wrapper = tint8.int8_einsum(eq, tx, node["__quant__"], node["scale"])
        plain = qm.int8_matmul_reference(eq, tx, node["__quant__"], node["scale"])
        assert torch.equal(via_wrapper, plain)
        assert dispatch.launch_counts()["int8_matmul"] == before  # the CPU launches nothing

    def test_unpack_int4_matches_jax(self):
        packed = np.random.default_rng(3).integers(0, 256, (3, 5), dtype=np.uint8)
        want = np.asarray(jint8._unpack_int4(jnp.asarray(packed)))
        got = tint8._unpack_int4(torch.from_numpy(packed))
        assert got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("eq", ["bsd,dhk->bshk", "bshk,hkd->bsd", "bsf,fd->bsd", "ij,jk->ik"])
    def test_contracted_axes_and_x_scale_match_jax(self, eq):
        assert tint8._x_contracted_axes(eq) == jint8._x_contracted_axes(eq)
        a = eq.split(",")[0]
        shape = tuple(1 if i in tint8._x_contracted_axes(eq) else 3 + i for i in range(len(a)))
        s = np.random.default_rng(4).random(shape).astype(np.float32)
        np.testing.assert_array_equal(
            tint8._x_scale_to_out(eq, torch.from_numpy(s)).numpy(),
            np.asarray(jint8._x_scale_to_out(eq, jnp.asarray(s))),
        )


class TestWeightScale:
    """The port's weight scale follows the JAX fallback's `_w_scale_to_out`
    broadcast, the per-h scale of the stacked q/k/v included."""

    @pytest.mark.parametrize("eq,xs,ws", MODEL_EQS, ids=[e[0] for e in MODEL_EQS])
    def test_w_scale_to_out_matches_jax(self, eq, xs, ws):
        w = np.random.default_rng(5).standard_normal(ws).astype(np.float32)
        node = jq.quantize_array(jnp.asarray(w), stack_dims=0)
        want = np.asarray(jint8._w_scale_to_out(eq, node["scale"]))
        got = tint8._w_scale_to_out(eq, torch.from_numpy(np.array(node["scale"])))
        np.testing.assert_array_equal(got.numpy(), want)

    @pytest.mark.parametrize("eq,xs,ws", MODEL_EQS, ids=[e[0] for e in MODEL_EQS])
    def test_kernel_column_scales_are_the_fallback_broadcast(self, eq, xs, ws):
        """What the CUDA wrapper hands the kernel: one fp32 scale per output
        column, equal to the fallback's scale broadcast over the output."""
        w = np.random.default_rng(6).standard_normal(ws).astype(np.float32)
        node = jq.quantize_array(jnp.asarray(w), stack_dims=0)
        plan = qm._plan(eq, xs, ws)
        cols = qm.column_scales(eq, torch.from_numpy(np.array(node["scale"])), plan)
        out_shape = jnp.einsum(eq, jnp.zeros(xs), jnp.zeros(ws)).shape
        full = np.broadcast_to(np.asarray(jint8._w_scale_to_out(eq, node["scale"])), out_shape)
        assert cols.shape == (plan.N,) and cols.dtype == torch.float32
        np.testing.assert_array_equal(
            np.broadcast_to(cols.numpy(), (plan.M, plan.N)), full.reshape(plan.M, plan.N))

    def test_per_h_scale_is_what_the_reference_kernel_refuses(self, monkeypatch, tmp_path):
        """The reference's Pallas `int8_matmul_fused` reshapes the weight
        scale to (1, N) and raises on the per-h scale (1, 1, h) of the
        stacked q/k/v layout; its fallback, and the port, broadcast it."""
        monkeypatch.setenv("ATX_AUTOTUNE_DIR", str(tmp_path))
        eq, xs, ws = MODEL_EQS[0]
        jx, _, w = _inputs(xs, ws, "fp32", seed=7)
        node = jq.quantize_array(jnp.asarray(w), stack_dims=0)
        assert node["scale"].shape == (1, 1, ws[-1])
        with pytest.raises(TypeError, match="reshape"):
            jqm.int8_matmul_fused(eq, jx, node["__quant__"], node["scale"], interpret=True)


class TestPlan:
    @pytest.mark.parametrize(
        "eq",
        ["bsd,dhk->bshk", "bshk,dhk->bsd", "bsd,bshk->dhk", "bshk,hkd->bsd", "bsd,hkd->bshk",
         "bshk,bsd->hkd", "ij,jk->ik", "ki,kj->ij", "ik,jk->ij", "ki,jk->ij", "ecd,edf->ecf",
         "ij,jk", "bsd,dsk->bk", "ij,ij->i", "abc,bd->acd"],
    )
    def test_parse_matches_jax(self, eq):
        assert qm._parse_matmul_eq(eq) == jqm._parse_matmul_eq(eq)

    def test_plan_shapes(self):
        plan = qm._plan("bsd,bshk->dhk", (2, 3, 4), (2, 3, 5, 6))
        assert (plan.oa, plan.ob, plan.M, plan.N, plan.C, plan.out_shape) == ("lead", "lead", 4, 30, 6, (4, 5, 6))
        assert qm._plan("ecd,edf->ecf", (2, 3, 4), (2, 4, 5)) is None


class TestMode:
    def test_context_nests_and_restores(self):
        assert not tint8.int8_compute_enabled()
        with tint8.int8_compute():
            assert tint8.int8_compute_enabled()
            with tint8.int8_compute(False):
                assert not tint8.int8_compute_enabled()
            assert tint8.int8_compute_enabled()
        assert not tint8.int8_compute_enabled()
        assert tint8.with_int8_compute(tint8.int8_compute_enabled)()

    @pytest.mark.parametrize("int8_on", [False, True])
    def test_matmul_einsum_routes_a_node_like_jax(self, int8_on):
        eq, xs, ws = MODEL_EQS[2]
        jx, tx, w = _inputs(xs, ws, "fp32", seed=8)
        node = jq.quantize_array(jnp.asarray(w), stack_dims=0)
        with force_kernels("off"), jint8.int8_compute(int8_on):
            want = jfp8.matmul_einsum(eq, jx, node)
        with tint8.int8_compute(int8_on):
            got = tfp8.matmul_einsum(eq, tx, _node_to_torch(node))
        # int8 path: bit-equal (above); dequantize path: one fp32 einsum of
        # the same operands in another summation order.
        np.testing.assert_allclose(_to_np(got), _to_np(want), rtol=1e-5, atol=1e-5)
        deq = tfp8.matmul_einsum(eq, tx, tq.dequantize_array(_node_to_torch(node), torch.float32))
        assert torch.equal(got, deq) != int8_on
