"""Port Llama (`accelerate_tpu_torch.models.llama`) against the JAX
package's, at `LlamaConfig.tiny` on the CPU, with the JAX weights loaded
through `models.convert.params_from_jax`.

Tolerances:
- fp32 params and fp32 cache: logits 1e-4 (fp32 on both sides; two layers
  of differently ordered sums, at logits of magnitude ~1).
- bf16 or int8 cache under fp32 params: 2e-2. Both sides round the same
  fp32 K/V to bf16 (or to int8 with bf16 scales), but a value within
  ~1e-7 of a rounding boundary may round one step apart (a bf16 ulp is
  4e-3 relative, an int8 step 1/127 of the row's max), and the prefill
  attention casts its probabilities to the cache dtype on both sides.
- bf16 params (the serving dtype): 6e-2 — every matmul output rounds to
  bf16, in another order in XLA and in PyTorch.
- Weight-only int8 / int4 trees (fp32 compute): the dequantize path 1e-4,
  as fp32 (the same dequantized weights on both sides). Under int8 compute
  2e-3: each product is bit-equal on equal inputs, but an activation that
  lands within fp32 noise of an int8 rounding boundary may round one step
  apart (1/127 of its row's max) on the two sides.
Greedy tokens must agree exactly; each case asserts that its top-2 logit
gap is wide enough that no near-tie decides the outcome.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu.models import llama as jllama
from accelerate_tpu.ops import int8 as jint8
from accelerate_tpu.utils import quantization as jq
from accelerate_tpu_torch import generation as tgen
from accelerate_tpu_torch.models import llama as tllama
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.ops import int8 as tint8
from accelerate_tpu_torch.serving import Engine, Request

CFG_J = jllama.LlamaConfig.tiny()
CFG_T = tllama.LlamaConfig.tiny()
# One compile per (tokens shape, cache dtype) instead of op-by-op dispatch.
_jax_fwc = jax.jit(jllama.forward_with_cache, static_argnums=3)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    """Random fp32 weights in the JAX layout, made with numpy from a seed
    (fan-in scaled; norm gains nonzero so the ``1 + scale`` path is live)."""
    rng = np.random.default_rng(0)
    flat = {}
    for key, shape in tllama.param_shapes(CFG_T).items():
        fan_in = shape[-1] if key.endswith("norm") else (shape[1] if key.startswith("blocks") else shape[0])
        std = 0.1 if key.endswith("norm") else (1.0 if key == "embed" else fan_in**-0.5)
        flat[key] = (rng.standard_normal(shape) * std).astype(np.float32)
    np_params = tllama.nest(flat)
    return jax.tree.map(jnp.asarray, np_params), params_from_jax(np_params, CFG_T, device="cpu")


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, CFG_J.vocab_size, (B, S)).astype(np.int32)


def _run_both(weights, jdtype, tdtype, steps=3, lengths=None, tol=1e-4, params_dtype=None):
    """Prefill 12 tokens, then ``steps`` greedy decode steps fed by the JAX
    side's argmax; compare every step's logits."""
    jp, tp = weights
    if params_dtype is not None:
        jp = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), CFG_T, device="cpu")
    prompt = _tokens(2, 12)
    jcache = jllama.init_cache(CFG_J, 2, 32, jdtype)
    tcache = tllama.init_cache(CFG_T, 2, 32, tdtype, device="cpu")
    jlog, jcache = _jax_fwc(jp, jnp.asarray(prompt), jcache, CFG_J)
    tlog, tcache = tllama.forward_with_cache(tp, torch.from_numpy(prompt), tcache, CFG_T)
    outs = [(jlog, tlog)]
    if lengths is not None:  # per-row cursors from here on
        jcache = dict(jcache, length=jnp.asarray(lengths, jnp.int32))
        tcache = dict(tcache, length=torch.tensor(lengths, dtype=torch.int32))
    tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    for _ in range(steps):
        jlog, jcache = _jax_fwc(jp, jnp.asarray(tok), jcache, CFG_J)
        tlog, tcache = tllama.forward_with_cache(tp, torch.from_numpy(tok), tcache, CFG_T)
        outs.append((jlog, tlog))
        tok = np.array(jnp.argmax(jlog[:, -1], -1), np.int32)[:, None]
    for jl, tl in outs:
        np.testing.assert_allclose(
            tl.float().numpy(), np.asarray(jnp.asarray(jl, jnp.float32)), rtol=tol, atol=tol
        )
    return tcache


class TestForwardWithCache:
    def test_fp32(self, weights):
        cache = _run_both(weights, jnp.float32, torch.float32)
        assert cache["length"] == 15 and cache["k"].dtype == torch.float32

    def test_per_row_cursors(self, weights):
        cache = _run_both(weights, jnp.float32, torch.float32, lengths=[7, 12])
        assert cache["length"].tolist() == [10, 15]

    def test_bf16_cache(self, weights):
        _run_both(weights, jnp.bfloat16, torch.bfloat16, tol=2e-2)

    def test_int8_cache(self, weights):
        cache = _run_both(weights, jnp.int8, torch.int8, tol=2e-2)
        assert cache["k_scale"].dtype == torch.bfloat16

    def test_bf16_params(self, weights):
        _run_both(weights, jnp.bfloat16, torch.bfloat16, steps=1, tol=6e-2, params_dtype="bf16")

    def test_cache_overflow_raises(self, weights):
        _, tp = weights
        cache = tllama.init_cache(CFG_T, 1, 8, torch.float32, device="cpu")
        with pytest.raises(ValueError, match="exceeds"):
            tllama.forward_with_cache(tp, torch.zeros(1, 9, dtype=torch.int32), cache, CFG_T)


def _assert_clear_argmax(params, seq, start, cfg):
    """Top-2 logit gap > 1e-3 at every generated position of ``seq``."""
    logits = np.asarray(jax.jit(jllama.forward, static_argnums=2)(params, jnp.asarray(seq), cfg))
    top2 = np.sort(logits[:, start - 1 : -1], axis=-1)[..., -2:]
    assert (top2[..., 1] - top2[..., 0]).min() > 1e-3


class TestGenerate:
    @pytest.mark.parametrize("kv", ["fp32", "bf16"])
    def test_greedy_matches_jax(self, weights, kv):
        jp, tp = weights
        prompt = _tokens(2, 10, seed=1)
        jout = jllama.generate(
            jp, jnp.asarray(prompt), CFG_J,
            generation_config=jgen.GenerationConfig(max_new_tokens=8, kv_cache_dtype=kv),
        )
        tout = tllama.generate(
            tp, torch.from_numpy(prompt), CFG_T,
            generation_config=tgen.GenerationConfig(max_new_tokens=8, kv_cache_dtype=kv),
        )
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        _assert_clear_argmax(jp, np.asarray(jout), 10, CFG_J)

    def test_eos_pads_and_stops_early(self, weights):
        jp, tp = weights
        prompt = _tokens(2, 10, seed=1)
        plain = tllama.generate(
            tp, torch.from_numpy(prompt), CFG_T,
            generation_config=tgen.GenerationConfig(max_new_tokens=8),
        )
        eos = int(plain[0, 12])  # row 0's third generated token
        gcfg = dict(max_new_tokens=8, eos_token_id=eos, pad_token_id=0)
        jout = jllama.generate(
            jp, jnp.asarray(prompt), CFG_J, generation_config=jgen.GenerationConfig(**gcfg)
        )
        gen = tgen.Generator(
            lambda p, t, c: tllama.forward_with_cache(p, t, c, CFG_T),
            lambda b, m: tllama.init_cache(CFG_T, b, m, device="cpu"),
            tgen.GenerationConfig(**gcfg),
            eos_check_every=2,
        )
        tout = gen(tp, torch.from_numpy(prompt))
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        assert (tout[0, 13:] == 0).all()

    def test_too_long_raises(self, weights):
        _, tp = weights
        with pytest.raises(ValueError, match="max_seq_len"):
            tllama.generate(
                tp, torch.zeros(1, 120, dtype=torch.int32), CFG_T,
                generation_config=tgen.GenerationConfig(max_new_tokens=16),
            )

    def test_sampling_is_seeded(self, weights):
        _, tp = weights
        cfg = tgen.GenerationConfig(max_new_tokens=6, do_sample=True, top_k=20, top_p=0.9)
        draw = lambda s: tllama.generate(
            tp, torch.from_numpy(_tokens(2, 5)), CFG_T, generation_config=cfg,
            generator=torch.Generator().manual_seed(s),
        )
        assert torch.equal(draw(3), draw(3))


class TestParamsAndConfig:
    def test_init_layout_matches_jax(self):
        port = tllama.init(CFG_T, seed=0, device="cpu")
        ref = jax.eval_shape(lambda key: jllama.init(key, CFG_J), jax.random.PRNGKey(0))
        shapes = lambda tree: {
            "/".join(str(getattr(k, "key", k)) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
        }
        assert shapes(port) == shapes(ref)

    @pytest.mark.parametrize("preset", ["tiny", "llama3_8b"])
    def test_param_count(self, preset):
        assert getattr(tllama.LlamaConfig, preset)().param_count() == getattr(
            jllama.LlamaConfig, preset
        )().param_count()

    @pytest.mark.parametrize("field", [{"n_experts": 4}, {"sliding_window": 16}])
    def test_unported_features_raise(self, field):
        with pytest.raises(NotImplementedError):
            tllama.init(tllama.LlamaConfig.tiny(**field), device="cpu")

    def test_converter_rejects_a_bad_tree(self, weights):
        np_params = jax.tree.map(np.asarray, weights[0])
        del np_params["final_norm"]
        with pytest.raises(ValueError, match="missing"):
            params_from_jax(np_params, CFG_T, device="cpu")
        np_params = jax.tree.map(np.array, weights[0])
        np_params["embed"] = np_params["embed"][:10]
        with pytest.raises(ValueError, match="shape"):
            params_from_jax(np_params, CFG_T, device="cpu")


class TestTraining:
    """`forward` and `loss_fn` (the training path) against the JAX
    package's, fp32 at `LlamaConfig.tiny`: loss 1e-5, logits and gradients
    1e-4 (two layers of fp32 sums in another order; the flash path runs
    the JAX Pallas kernels in interpret mode against the port's plain
    versions of its CUDA kernels)."""

    @pytest.fixture(autouse=True)
    def _autotune_dir(self, tmp_path, monkeypatch):
        # The JAX flash entry point banks its block choice in this table.
        monkeypatch.setenv("ATX_AUTOTUNE_DIR", str(tmp_path))

    @staticmethod
    def _leaves(weights):
        np_params = jax.tree.map(np.asarray, weights[0])
        flat = tllama.flatten(params_from_jax(np_params, CFG_T, device="cpu"))
        return tllama.nest({k: v.requires_grad_() for k, v in flat.items()})

    @pytest.mark.parametrize("impl", ["dot", "flash"])
    def test_loss_and_gradients_match_jax(self, weights, impl):
        jcfg = jllama.LlamaConfig.tiny(attention_impl=impl)
        tcfg = tllama.LlamaConfig.tiny(attention_impl=impl)
        tokens = _tokens(2, 32, seed=4)
        grad_fn = jax.jit(jax.value_and_grad(lambda p, t: jllama.loss_fn(p, {"input_ids": t}, jcfg)))
        jloss, jgrads = grad_fn(weights[0], jnp.asarray(tokens))
        params = self._leaves(weights)
        loss = tllama.loss_fn(params, {"input_ids": torch.from_numpy(tokens)}, tcfg)
        loss.backward()
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        for key, want in tllama.flatten(jgrads).items():
            got = tllama.flatten(params)[key].grad
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4, err_msg=key)

    @pytest.mark.parametrize("impl", ["dot", "flash"])
    def test_forward_logits_match_jax(self, weights, impl):
        tokens = _tokens(2, 24, seed=6)
        want = jllama.forward(weights[0], jnp.asarray(tokens), jllama.LlamaConfig.tiny(attention_impl=impl))
        got = tllama.forward(weights[1], torch.from_numpy(tokens), tllama.LlamaConfig.tiny(attention_impl=impl))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
        hidden = tllama.forward(weights[1], torch.from_numpy(tokens), CFG_T, return_hidden=True)
        assert hidden.shape == (2, 24, CFG_T.d_model)

    def test_masked_batch_with_labels_and_z_loss(self, weights):
        """An attention mask routes flash to the plain attention (as in
        JAX) and masks the loss; explicit labels are not shifted."""
        tokens = _tokens(2, 20, seed=7)
        labels = _tokens(2, 20, seed=8)
        mask = np.ones((2, 20), np.int32)
        mask[1, 14:] = 0
        batch = {"input_ids": tokens, "labels": labels, "attention_mask": mask}
        jcfg = jllama.LlamaConfig.tiny(attention_impl="flash", z_loss=1e-3)
        tcfg = tllama.LlamaConfig.tiny(attention_impl="flash", z_loss=1e-3)
        want = jax.jit(jllama.loss_fn, static_argnums=2)(
            weights[0], {k: jnp.asarray(v) for k, v in batch.items()}, jcfg
        )
        got = tllama.loss_fn(weights[1], {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
        assert got.item() == pytest.approx(float(want), rel=1e-5)

    def test_training_fields_match_jax_defaults(self):
        fields = ("remat", "remat_policy", "attention_impl", "z_loss", "loss_chunk_size")
        j, t = jllama.LlamaConfig(), tllama.LlamaConfig()
        assert {f: getattr(t, f) for f in fields} == {f: getattr(j, f) for f in fields}

    @pytest.mark.parametrize(
        "field,error",
        [({"loss_chunk_size": 8}, NotImplementedError), ({"attention_impl": "ring"}, NotImplementedError),
         ({"attention_impl": "ulysses"}, NotImplementedError), ({"attention_impl": "sparse"}, ValueError)],
        ids=["chunked-loss", "ring", "ulysses", "unknown"],
    )
    def test_unported_training_options_raise(self, weights, field, error):
        with pytest.raises(error):
            tllama.forward(weights[1], torch.zeros(1, 16, dtype=torch.int64), tllama.LlamaConfig.tiny(**field))


class TestQuantized:
    """A weight-only quantized tiny Llama from the JAX `quantize_pytree`,
    carried across by `params_from_jax`, through `forward` (the dequantize
    path and `int8_compute`), `forward_with_cache` and the serving
    `Engine`."""

    @pytest.fixture(scope="class", params=[8, 4], ids=["int8", "int4"])
    def qweights(self, request, weights):
        jtree = jq.quantize_pytree(weights[0], bits=request.param)
        return jtree, params_from_jax(jax.device_get(jtree), CFG_T, device="cpu")

    def test_forward_dequantize_path(self, qweights):
        tokens = _tokens(2, 24, seed=9)
        want = jax.jit(jllama.forward, static_argnums=2)(qweights[0], jnp.asarray(tokens), CFG_J)
        got = tllama.forward(qweights[1], torch.from_numpy(tokens), CFG_T)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)

    def test_forward_int8_compute(self, qweights):
        tokens = _tokens(2, 24, seed=10)
        fwd = jax.jit(jint8.with_int8_compute(jllama.forward), static_argnums=2)
        want = np.asarray(fwd(qweights[0], jnp.asarray(tokens), CFG_J))
        with tint8.int8_compute():
            got = tllama.forward(qweights[1], torch.from_numpy(tokens), CFG_T).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
        deq = tllama.forward(qweights[1], torch.from_numpy(tokens), CFG_T).numpy()
        assert np.abs(got - deq).max() > 0  # the int8 products really ran

    def test_forward_with_cache(self, qweights):
        cache = _run_both(qweights, jnp.float32, torch.float32)
        assert cache["length"] == 15

    def test_forward_with_cache_int8_compute(self, qweights):
        prompt = _tokens(2, 12, seed=11)
        fwc = jax.jit(jint8.with_int8_compute(jllama.forward_with_cache), static_argnums=3)
        jlog, _ = fwc(qweights[0], jnp.asarray(prompt), jllama.init_cache(CFG_J, 2, 16, jnp.float32), CFG_J)
        with tint8.int8_compute():
            tlog, _ = tllama.forward_with_cache(
                qweights[1], torch.from_numpy(prompt), tllama.init_cache(CFG_T, 2, 16, torch.float32, device="cpu"),
                CFG_T,
            )
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=2e-3, atol=2e-3)

    def test_engine_serves_a_quantized_tree(self, qweights):
        """Each completion equals batch-1 `generate` from the same tree."""
        tp = qweights[1]
        gcfg = tgen.GenerationConfig(max_new_tokens=5)
        engine = Engine(
            lambda p, t, c: tllama.forward_with_cache(p, t, c, CFG_T),
            lambda b, m: tllama.init_cache(CFG_T, b, m, torch.float32, device="cpu"),
            tp, gcfg, slots=2, buckets=(8, 16), max_len=32,
        )
        prompts = [_tokens(1, n, seed=20 + n)[0] for n in (5, 9, 12)]
        completions = engine.serve([Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
        assert sorted(c.rid for c in completions) == [0, 1, 2]
        for c in completions:
            solo = tllama.generate(tp, torch.from_numpy(prompts[c.rid][None]), CFG_T, generation_config=gcfg)
            np.testing.assert_array_equal(c.tokens[: c.n_new], solo[0, len(prompts[c.rid]):].numpy())
