"""Port `models/layers.py` functions against the JAX package's, on the same
numpy inputs, in fp32 on the CPU.

Tolerance 1e-5 (absolute and relative): both sides compute in fp32 and
differ only in the order of their sums. The cache ops are exact. JAX's
cache ops return updated copies; the port's write in place and return the
same tensor, which the tests check too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu.models import layers as jl
from accelerate_tpu_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **(tol or TOL))


class TestNormRope:
    def test_rms_norm(self):
        x, s = _rand(2, 5, 32), _rand(32, seed=1) * 0.1
        _close(tl.rms_norm(_t(x), _t(s), 1e-5), jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))

    def test_rms_norm_bf16_keeps_dtype(self):
        x = torch.from_numpy(_rand(2, 3, 16)).bfloat16()
        assert tl.rms_norm(x, torch.zeros(16)).dtype == torch.bfloat16

    @pytest.mark.parametrize(
        "scaling",
        [None, ("linear", 4.0), ("llama3", 8.0)],
        ids=["plain", "linear", "llama3"],
    )
    def test_rope_frequencies(self, scaling):
        kw = lambda mod: {} if scaling is None else {
            "scaling": mod.RopeScaling(scaling[0], scaling[1], original_max_position_embeddings=64)
        }
        port = tl.rope_frequencies(32, 96, 500000.0, **kw(tl))
        ref = jl.rope_frequencies(32, 96, 500000.0, **kw(jl))
        for p, r in zip(port, ref):
            np.testing.assert_array_equal(p, r)

    def test_apply_rope(self):
        cos, sin = jl.rope_frequencies(16, 64, 10000.0)
        x = _rand(2, 3, 4, 16)
        pos = np.array([[0, 1, 2], [7, 8, 9]])
        ref = jl.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jnp.asarray(pos))
        _close(tl.apply_rope(_t(x), _t(cos), _t(sin), _t(pos)), ref)


class TestCacheOps:
    @pytest.mark.parametrize("start", [5, [0, 3, 9]], ids=["scalar", "per-row"])
    def test_cache_positions(self, start):
        t_start = start if isinstance(start, int) else torch.tensor(start, dtype=torch.int32)
        port = tl.cache_positions(t_start, 4, 3)
        ref = jl.cache_positions(jnp.asarray(start, jnp.int32), 4, 3)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))

    @pytest.mark.parametrize(
        "start", [3, 14, [0, 5, 13]], ids=["scalar", "scalar-clamped", "per-row-clamped"]
    )
    def test_cache_write(self, start):
        buf, new = _rand(3, 16, 2, 4), _rand(3, 4, 2, 4, seed=1)
        t_start = start if isinstance(start, int) else torch.tensor(start, dtype=torch.int32)
        tbuf = _t(buf)
        port = tl.cache_write(tbuf, _t(new), t_start)
        ref = jl.cache_write(jnp.asarray(buf), jnp.asarray(new), jnp.asarray(start, jnp.int32))
        assert port is tbuf  # in place
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))

    def test_cache_write_casts_to_the_buffer_dtype(self):
        buf = torch.zeros(1, 4, 2, dtype=torch.bfloat16)
        tl.cache_write(buf, torch.ones(1, 1, 2), 1)
        assert buf.dtype == torch.bfloat16 and buf[0, 1].tolist() == [1.0, 1.0]

    @pytest.mark.parametrize("start", [2, [1, 6]], ids=["scalar", "per-row"])
    def test_cache_write_stacked(self, start):
        all_buf, rows = _rand(3, 2, 8, 2, 4), _rand(2, 2, 2, 4, seed=1)
        t_start = start if isinstance(start, int) else torch.tensor(start, dtype=torch.int32)
        port_all, port_layer = tl.cache_write_stacked(_t(all_buf), 1, _t(rows), t_start)
        ref_all, ref_layer = jl.cache_write_stacked(
            jnp.asarray(all_buf), jnp.int32(1), jnp.asarray(rows), jnp.asarray(start, jnp.int32)
        )
        np.testing.assert_array_equal(port_all.numpy(), np.asarray(ref_all))
        np.testing.assert_array_equal(port_layer.numpy(), np.asarray(ref_layer))

    def test_slot_view_write_and_copy(self):
        kv = {"k": _rand(2, 4, 8, 2, 3), "k_scale": _rand(2, 4, 8, 2, seed=1)}
        tkv = {n: _t(a) for n, a in kv.items()}
        jkv = {n: jnp.asarray(a) for n, a in kv.items()}
        view = tl.cache_slot_view(tkv, 2)
        for n in kv:
            np.testing.assert_array_equal(view[n].numpy(), np.asarray(jl.cache_slot_view(jkv, 2)[n]))
        # Writing the view back is a no-op; writing a new row lands in slot 1.
        row = {n: _t(_rand(*view[n].shape, seed=5)) for n in kv}
        tl.cache_slot_write(tkv, view, 2)
        tl.cache_slot_write(tkv, row, 1)
        ref = jl.cache_slot_write(jkv, {n: jnp.asarray(r.numpy()) for n, r in row.items()}, 1)
        for n in kv:
            np.testing.assert_array_equal(tkv[n].numpy(), np.asarray(ref[n]))
        # Copy 3 positions at offset 2 from row 0 of a second pool into slot 3.
        src = {n: _rand(2, 1, 8, *a.shape[3:], seed=7) for n, a in kv.items()}
        tl.cache_slot_copy(tkv, {n: _t(a) for n, a in src.items()}, 3, 0, 2, 3)
        ref = jl.cache_slot_copy(ref, {n: jnp.asarray(a) for n, a in src.items()}, 3, 0, 2, 3)
        for n in kv:
            np.testing.assert_array_equal(tkv[n].numpy(), np.asarray(ref[n]))


class TestAttention:
    @pytest.mark.parametrize(
        "K,causal,mask", [(4, True, None), (2, False, "padding"), (1, False, "full")],
        ids=["mha-causal", "gqa-padding-mask", "mqa-full-mask"],
    )
    def test_dot_product_attention(self, K, causal, mask):
        q, k, v = _rand(2, 5, 4, 8), _rand(2, 7, K, 8, seed=1), _rand(2, 7, K, 8, seed=2)
        m = None
        if mask == "padding":
            m = np.arange(7)[None, :] < np.array([[4], [7]])
        elif mask == "full":
            m = np.random.default_rng(3).random((2, 5, 7)) > 0.3
        ref = jl.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=None if m is None else jnp.asarray(m), causal=causal,
        )
        port = tl.dot_product_attention(
            _t(q), _t(k), _t(v), mask=None if m is None else _t(m), causal=causal
        )
        _close(port, ref)

    def test_cached_decode_attention_decode_step(self):
        # Decode: the port runs the plain flash-decode over the cursor; JAX
        # (kernels off) runs the masked reference over the same cache.
        q, k, v = _rand(3, 1, 4, 8), _rand(3, 16, 2, 8, seed=1), _rand(3, 16, 2, 8, seed=2)
        lengths = np.array([1, 9, 16], np.int32)
        mask = (np.arange(16)[None, None, :] < lengths[:, None, None])
        ref = jl.cached_decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=jnp.asarray(mask), lengths=jnp.asarray(lengths),
        )
        port = tl.cached_decode_attention(_t(q), _t(k), _t(v), lengths=_t(lengths))
        _close(port, ref)

    def test_cached_decode_attention_int8_prefill(self):
        # Prefill over an int8 cache: the port dequantizes where it reads.
        from accelerate_tpu.models.llama import _dequant_kv, _quantize_kv

        q, k, v = _rand(1, 3, 4, 8), _rand(1, 16, 2, 8, seed=1), _rand(1, 16, 2, 8, seed=2)
        kq, ks = _quantize_kv(jnp.asarray(k))
        vq, vs = _quantize_kv(jnp.asarray(v))
        mask = np.arange(16)[None, None, :] <= np.arange(4, 7)[None, :, None]
        ref = jl.cached_decode_attention(
            jnp.asarray(q), _dequant_kv(kq, ks, jnp.float32), _dequant_kv(vq, vs, jnp.float32),
            mask=jnp.asarray(mask),
        )
        bf = lambda a: torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).bfloat16()
        port = tl.cached_decode_attention(
            _t(q), _t(kq), _t(vq), mask=_t(mask), k_scale=bf(ks), v_scale=bf(vs)
        )
        _close(port, ref)

    def test_quantize_kv_matches(self):
        from accelerate_tpu.models.llama import _quantize_kv

        x = _rand(2, 5, 2, 8) * 3
        kq, ks = _quantize_kv(jnp.asarray(x))
        pq, ps = tl.quantize_kv(_t(x))
        np.testing.assert_array_equal(pq.numpy(), np.asarray(kq))
        np.testing.assert_array_equal(ps.float().numpy(), np.asarray(jnp.asarray(ks, jnp.float32)))

    def test_attention_block(self):
        w = {
            "wq": _rand(16, 4, 8, seed=1), "wk": _rand(16, 2, 8, seed=2),
            "wv": _rand(16, 2, 8, seed=3), "wo": _rand(4, 8, 16, seed=4),
        }
        x = _rand(2, 3, 16)
        jw = {n: jnp.asarray(a) for n, a in w.items()}
        tw = {n: _t(a) for n, a in w.items()}
        for p, r in zip(tl.attention_qkv(tw, _t(x)), jl.attention_qkv(jw, jnp.asarray(x))):
            _close(p, r)
        attn = _rand(2, 3, 4, 8, seed=9)
        _close(tl.attention_out(tw, _t(attn)), jl.attention_out(jw, jnp.asarray(attn)))

    def test_swiglu(self):
        w = {"w_gate": _rand(16, 32, seed=1), "w_up": _rand(16, 32, seed=2), "w_down": _rand(32, 16, seed=3)}
        x = _rand(2, 3, 16)
        ref = jl.swiglu({n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(x))
        _close(tl.swiglu({n: _t(a) for n, a in w.items()}, _t(x)), ref)


class TestInit:
    def test_truncated_normal(self):
        gen = torch.Generator().manual_seed(0)
        out = tl.truncated_normal_init(gen, (4096,), 0.5)
        assert out.abs().max() <= 1.0 and abs(out.std().item() - 0.5 * 0.88) < 0.03

    def test_init_shapes_match_jax(self):
        import jax

        spec_t = tl.AttentionSpec(16, 4, 2, 8)
        spec_j = jl.AttentionSpec(16, 4, 2, 8)
        gen = torch.Generator().manual_seed(0)
        port = {**tl.init_attention(gen, spec_t), **tl.init_swiglu(gen, 16, 32)}
        ref = jax.eval_shape(lambda key: {
            **jl.init_attention(key, spec_j), **jl.init_swiglu(key, 16, 32),
        }, jax.random.PRNGKey(0))
        assert {n: tuple(a.shape) for n, a in port.items()} == {n: a.shape for n, a in ref.items()}
