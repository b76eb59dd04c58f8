"""Port weight quantization (`accelerate_tpu_torch.utils.quantization`, the
quantized-tree path of `utils.tree` and `models.convert`) against the JAX
package's `utils/quantization.py`, on the CPU, from the same numpy inputs.

Tolerances: none for the quantized values and scales, which must be
bit-equal (the same fp32 amax, division and half-to-even rounding on both
sides). Dequantized values: bit-equal in fp32 (one product of the same
fp32 operands); in bf16, the same product rounded once on each side, also
bit-equal.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch.models import llama
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.utils import quantization as tq
from accelerate_tpu_torch.utils.tree import flatten, map_tree


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if x.dtype == jnp.bfloat16 else np.asarray(x)


def _assert_nodes_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        g = got[key]
        assert tuple(g.shape) == w.shape, key
        assert str(g.dtype).split(".")[-1] == w.dtype.name, (key, g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=key)


def _stacked_tree(cfg, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in llama.param_shapes(cfg).items():
        flat[key] = (rng.standard_normal(shape) * 0.05).astype(dtype)
    return llama.nest(flat)


class TestQuantizeArray:
    @pytest.mark.parametrize("bits", [8, 4])
    @pytest.mark.parametrize(
        "shape,stack_dims",
        [((64, 96), None), ((64, 96), 0), ((3, 32, 48), None), ((2, 32, 4, 8), None),
         ((2, 32, 4, 8), 0), ((2, 3, 16, 24), 2), ((3, 32, 47), None)],
        ids=lambda v: str(v),
    )
    def test_values_and_scales_bit_equal(self, shape, stack_dims, bits):
        w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
        w[..., 0] *= 30.0  # an outlier channel
        want = jq.quantize_array(jnp.asarray(w), stack_dims=stack_dims, bits=bits)
        got = tq.quantize_array(torch.from_numpy(w), stack_dims=stack_dims, bits=bits)
        _assert_nodes_equal(got, want)
        odd = bits == 4 and shape[-1] % 2
        assert (tq._QUANT4_KEY in got) == (bits == 4 and not odd)

    def test_bf16_input_and_halfway_values(self):
        """bf16 leaves quantize from their fp32 values, and x / scale landing
        on a .5 rounds half to even on both sides."""
        w = np.random.default_rng(2).standard_normal((16, 8)).astype(np.float32)
        w[:, 3] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 0.0] * 2  # scale 1 on this channel
        wb = jnp.asarray(w, jnp.bfloat16)
        want = jq.quantize_array(wb)
        got = tq.quantize_array(torch.from_numpy(w).to(torch.bfloat16))
        _assert_nodes_equal(got, want)
        assert got["__quant__"][1:8, 3].tolist() == [0, 2, 2, 0, -2, 4, 0]

    def test_bad_bits_raises(self):
        with pytest.raises(ValueError, match="bits"):
            tq.quantize_array(torch.zeros(4, 4), bits=3)

    @pytest.mark.parametrize("bits", [8, 4])
    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["fp32", "bf16"])
    def test_dequantize_bit_equal(self, bits, dtype):
        w = np.random.default_rng(3).standard_normal((2, 32, 4, 8)).astype(np.float32)
        jnode = jq.quantize_array(jnp.asarray(w), bits=bits)
        tnode = tq.quantize_array(torch.from_numpy(w), bits=bits)
        want = _np(jq.dequantize_array(jnode, dtype))
        tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
        got = tq.dequantize_array(tnode, tdtype)
        assert got.dtype == tdtype
        np.testing.assert_array_equal(got.float().numpy(), want)


class TestLeafPlan:
    @pytest.mark.parametrize(
        "path,shape,dtype",
        [
            ("blocks/attn/wq", (2, 64, 4, 16), "float32"),
            ("blocks/attn/wk", (2, 64, 2, 16), "bfloat16"),
            ("blocks/mlp/w_gate", (2, 64, 128), "float32"),
            ("blocks/attn_norm", (2, 64), "float32"),
            ("embed", (256, 64), "float32"),
            ("lm_head", (64, 256), "float32"),
            ("blocks/moe/w_in", (2, 4, 64, 128), "float32"),
            ("blocks/expert/w", (2, 64), "float32"),
            ("small", (8, 8), "float32"),
            ("vector", (8192,), "float32"),
            ("ids", (128, 128), "int32"),
            ("blocks/attn/b", (64, 128), "float32"),
            ("router/w", (64, 128), "float32"),
        ],
    )
    def test_same_decisions_as_jax(self, path, shape, dtype):
        want = jq.leaf_quant_plan(path, shape, jnp.dtype(dtype))
        got = tq.leaf_quant_plan(path, shape, getattr(torch, dtype))
        assert got == want

    def test_skip_patterns_match(self):
        assert tq.DEFAULT_SKIP_PATTERNS == jq.DEFAULT_SKIP_PATTERNS
        assert tq.DEFAULT_STACK_DIM_PATTERNS == jq.DEFAULT_STACK_DIM_PATTERNS


class TestQuantizePytree:
    CFG = llama.LlamaConfig.tiny()

    @pytest.mark.parametrize("bits", [8, 4])
    def test_stacked_llama_tree_bit_equal(self, bits):
        tree = _stacked_tree(self.CFG)
        want = jax.device_get(jq.quantize_pytree(jax.tree.map(jnp.asarray, tree), bits=bits))
        got = tq.quantize_pytree(map_tree(torch.from_numpy, tree), bits=bits)
        wflat, gflat = flatten(want), flatten(got)
        assert set(wflat) == set(gflat)
        quantized = sorted(k for k, v in gflat.items() if tq.is_quantized(v))
        assert quantized == sorted(
            f"blocks.{k}" for k in ("attn.wq", "attn.wk", "attn.wv", "attn.wo", "mlp.w_gate", "mlp.w_up", "mlp.w_down")
        )
        for key, w in wflat.items():
            if tq.is_quantized(w):
                _assert_nodes_equal(gflat[key], w)
            else:
                np.testing.assert_array_equal(gflat[key].numpy(), np.asarray(w), err_msg=key)
        # The stacked q/k/v scales keep head_dim and one slice per layer.
        L, h = self.CFG.n_layers, self.CFG.resolved_head_dim
        assert tuple(gflat["blocks.attn.wq"]["scale"].shape) == (L, 1, 1, h)
        assert tq.has_quantized(got) and not tq.has_quantized(map_tree(torch.from_numpy, tree))
        assert tq.quantized_nbytes(got) == jq.quantized_nbytes(want)

    def test_dequantize_pytree_bit_equal(self):
        tree = _stacked_tree(self.CFG)
        jtree = jq.quantize_pytree(jax.tree.map(jnp.asarray, tree))
        want = flatten(jax.device_get(jq.dequantize_pytree(jtree, jnp.float32)))
        got = flatten(tq.dequantize_pytree(tq.quantize_pytree(map_tree(torch.from_numpy, tree)), torch.float32))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)


class TestConvert:
    CFG = llama.LlamaConfig.tiny()

    @pytest.mark.parametrize("bits", [8, 4])
    def test_params_from_jax_carries_a_quantized_tree(self, bits):
        tree = _stacked_tree(self.CFG)
        jtree = jax.device_get(jq.quantize_pytree(jax.tree.map(jnp.asarray, tree), bits=bits))
        got = params_from_jax(jtree, self.CFG, device="cpu")
        want = tq.quantize_pytree(map_tree(torch.from_numpy, tree), bits=bits)
        gflat, wflat = flatten(got), flatten(want)
        assert set(gflat) == set(wflat)
        for key, w in wflat.items():
            if tq.is_quantized(w):
                assert set(gflat[key]) == set(w)
                for k in w:
                    assert gflat[key][k].dtype == w[k].dtype and torch.equal(gflat[key][k], w[k]), key
            else:
                assert torch.equal(gflat[key], w), key

    def test_params_from_jax_checks_the_quantized_shape(self):
        tree = _stacked_tree(self.CFG)
        jtree = jax.device_get(jq.quantize_pytree(jax.tree.map(jnp.asarray, tree)))
        jtree["blocks"]["attn"]["wq"]["__quant__"] = jtree["blocks"]["attn"]["wq"]["__quant__"][:, :8]
        with pytest.raises(ValueError, match="wq"):
            params_from_jax(jtree, self.CFG, device="cpu")

    @pytest.mark.parametrize("name", ["float8_e4m3fn", "float8_e5m2"])
    def test_float8_leaves_cross_bit_for_bit(self, name):
        from accelerate_tpu_torch.models.convert import _to_tensor

        x = (np.random.default_rng(4).standard_normal((5, 7)) * 8).astype(getattr(ml_dtypes, name))
        got = _to_tensor(x, torch.device("cpu"))
        assert got.dtype == getattr(torch, name)
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(), x.view(np.uint8))


class TestTree:
    def test_quantized_nodes_are_leaves(self):
        node = tq.quantize_array(torch.randn(64, 64))
        tree = {"a": {"w": node, "b": torch.zeros(3)}}
        assert list(flatten(tree)) == ["a.w", "a.b"]
        assert flatten(tree)["a.w"] is node
        seen = []
        map_tree(seen.append, tree)
        assert seen[0] is node and len(seen) == 2
