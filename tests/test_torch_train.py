"""Port train core (`accelerate_tpu_torch.{accelerator, optim}`,
`utils.dataclasses`, the loss and the remat policies of `models.layers`)
against the JAX package, on the CPU, from the same numpy inputs.

Tolerances:
- `cross_entropy_loss`, `global_norm`: 1e-6 relative (fp32, one reduction
  in another order).
- `optim.adamw` against `optax.adamw`: 1e-6 over 3 updates (fp32; the
  update is the same formula, in another order of operations).
- `Accelerator.make_train_step` against the JAX one, `LlamaConfig.tiny`,
  fp32: loss and grad norm 1e-5 per step; params after 3 steps within 1e-4
  of each other, and 1e-6 on average. The gradients agree to ~1e-6
  relative (two layers of fp32 sums in another order), but Adam divides by
  sqrt(v) ~ |g|: an element whose gradient is near 0 (an embedding row of
  a token seen once) moves by up to lr 1e-3 a step on a gradient whose
  relative error is large, so a few elements differ by ~1e-4.
- Remat on vs off: 1e-6 (the recompute repeats the forward's arithmetic).
- fp8 (`ops.fp8`) in fp32 compute against JAX's fp8 loss and gradients:
  1e-5 relative per leaf (measured 3e-7): the fp8 operands are bit-equal
  unless an fp32 value sits within summation-order noise of an fp8
  rounding boundary, and the fp8 products are exact in fp32.
- The fp8 train step (bf16 compute, `mixed_precision="fp8"`) against
  JAX's: loss 1e-3 and grad norm 2e-2 relative (measured 4e-5 and 3e-3),
  each leaf's gradient 0.3 in relative norm (measured at most 0.14). The
  two frameworks round bf16 activations at different places; one amax a
  bf16 ulp apart changes a tensor's scale and so re-rounds every element,
  and e5m2 cotangents keep two mantissa bits (up to 12.5 % an element).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from accelerate_tpu import accelerator as jacc
from accelerate_tpu.models import layers as jlayers
from accelerate_tpu.models import llama as jllama
from accelerate_tpu.ops import fp8 as jfp8
from accelerate_tpu.utils.dataclasses import MixedPrecisionPolicy as JaxPolicy
from accelerate_tpu_torch import optim
from accelerate_tpu_torch.accelerator import Accelerator, global_norm
from accelerate_tpu_torch.models import layers, llama
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.native import dispatch
from accelerate_tpu_torch.native import flash_attention as fa
from accelerate_tpu_torch.ops import fp8 as tfp8
from accelerate_tpu_torch.utils.dataclasses import (
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    PrecisionType,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _weights(cfg, seed=0):
    """Random fp32 weights in the JAX layout, from numpy (norm gains
    nonzero so the ``1 + scale`` path is live)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in llama.param_shapes(cfg).items():
        fan_in = shape[1] if key.startswith("blocks") else shape[0]
        std = 0.1 if key.endswith("norm") else (1.0 if key == "embed" else fan_in**-0.5)
        flat[key] = (rng.standard_normal(shape) * std).astype(np.float32)
    return llama.nest(flat)


def _tokens(B, S, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------------- loss
class TestCrossEntropy:
    @pytest.mark.parametrize("z_loss", [0.0, 1e-3])
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_jax(self, z_loss, masked):
        rng = np.random.default_rng(1)
        logits = rng.standard_normal((3, 7, 50), dtype=np.float32) * 3
        labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
        mask = (rng.random((3, 7)) > 0.3).astype(np.int32) if masked else None
        want = jlayers.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(labels),
            mask=None if mask is None else jnp.asarray(mask), z_loss=z_loss,
        )
        got = layers.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(labels),
            mask=None if mask is None else torch.from_numpy(mask), z_loss=z_loss,
        )
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)

    def test_all_masked_is_zero_not_nan(self):
        logits = torch.randn(2, 3, 5)
        got = layers.cross_entropy_loss(logits, torch.zeros(2, 3, dtype=torch.long), mask=torch.zeros(2, 3))
        assert got.item() == 0.0


# --------------------------------------------------------------------- remat
def _grads(cfg, params_np, tokens):
    params = llama.nest({k: v.detach().clone().requires_grad_() for k, v in
                         llama.flatten(params_from_jax(params_np, cfg, device="cpu")).items()})
    loss = llama.loss_fn(params, {"input_ids": torch.from_numpy(tokens)}, cfg)
    loss.backward()
    return loss.item(), {k: v.grad for k, v in llama.flatten(params).items()}


class TestRemat:
    @pytest.mark.parametrize("policy", ["nothing", "dots", "block_outputs", "attn_and_outputs"])
    @pytest.mark.parametrize("impl", ["dot", "flash"])
    def test_same_loss_and_gradients_as_no_remat(self, policy, impl):
        base = llama.LlamaConfig.tiny(attention_impl=impl)
        params_np = _weights(base)
        tokens = _tokens(2, 32, base.vocab_size, 3)
        loss0, g0 = _grads(base, params_np, tokens)
        loss1, g1 = _grads(llama.LlamaConfig.tiny(attention_impl=impl, remat=True, remat_policy=policy),
                           params_np, tokens)
        assert loss1 == pytest.approx(loss0, rel=1e-6)
        for key in g0:
            np.testing.assert_allclose(g1[key].numpy(), g0[key].numpy(), rtol=1e-6, atol=1e-7, err_msg=key)

    @pytest.mark.parametrize("policy", ["nothing", "dots", "block_outputs", "attn_and_outputs"])
    def test_backward_recomputes_what_the_policy_drops(self, policy):
        """The backward's matmul FLOPs minus the no-remat backward's are the
        forward matmuls the policy recomputes, as JAX's remat does: under
        "nothing" every block matmul whose output the backward needs (not
        the down projection, which only feeds the residual add); under
        "block_outputs" not the output projection either (``attn_out`` is
        kept); under "attn_and_outputs" only gate and up (the q/k/v outputs
        are kept and only their norm re-runs); none under "dots", which
        keeps every projection output."""
        from torch.utils.flop_counter import FlopCounterMode

        B, S = 2, 16

        def backward_mm_flops(cfg):
            params = llama.nest({k: v.detach().requires_grad_() for k, v in
                                 llama.flatten(params_from_jax(_weights(cfg), cfg, device="cpu")).items()})
            tokens = torch.from_numpy(_tokens(B, S, cfg.vocab_size, 4))
            loss = llama.loss_fn(params, {"input_ids": tokens}, cfg)
            with FlopCounterMode(display=False) as counter:
                loss.backward()
            counts = counter.get_flop_counts()["Global"]
            return sum(n for op, n in counts.items() if str(op) in ("aten.mm", "aten.addmm"))

        cfg = llama.LlamaConfig.tiny(remat=True, remat_policy=policy)
        D, H, K, h, F = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.d_ff
        per_layer = {
            "qkv": 2 * B * S * D * (H + 2 * K) * h,
            "out": 2 * B * S * H * h * D,
            "gate_up": 2 * 2 * B * S * D * F,
        }
        recomputed = {
            "nothing": ("qkv", "out", "gate_up"),
            "block_outputs": ("qkv", "gate_up"),
            "attn_and_outputs": ("gate_up",),
            "dots": (),
        }[policy]
        extra = backward_mm_flops(cfg) - backward_mm_flops(llama.LlamaConfig.tiny())
        assert extra == cfg.n_layers * sum(per_layer[name] for name in recomputed)

    def test_attn_and_outputs_keeps_the_block_input_not_the_normed_h(self):
        """The ``attn_and_outputs`` block saves for its backward the
        activations JAX's policy keeps: the block input (JAX's carry), the
        q/k/v segment inputs (``q_rope``, ``k_rope``, ``v_proj``) and the
        mid-block residual (``x + attn_out``, the MLP segment's input). The
        norm before q/k/v re-runs in the backward; plain autograd of
        `normed_qkv` would keep the normed h (and the norm's fp32
        intermediates) besides."""
        cfg = llama.LlamaConfig.tiny(remat=True, remat_policy="attn_and_outputs")
        params = params_from_jax(_weights(cfg), cfg, device="cpu")
        block = llama.nest({k: v[0].requires_grad_() for k, v in llama.flatten(params["blocks"]).items()})
        B, S, H, K, h = 2, 16, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        x = torch.randn(B, S, cfg.d_model, generator=torch.Generator().manual_seed(0), requires_grad=True)
        cos, sin = llama._rope_tables(cfg, x.device)
        positions = torch.arange(S)[None, :].expand(B, S)

        def saved_activations(fn):
            saved = []
            with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
                out = fn()
            out.sum().backward()  # the kept set suffices
            return [t for t in saved if t.shape[:2] == (B, S) and t.requires_grad]

        kept = saved_activations(lambda: llama.block_forward(
            block, x, config=cfg, cos=cos, sin=sin, positions=positions, mask=None))
        assert [tuple(t.shape) for t in kept] == [x.shape, (B, S, H, h), (B, S, K, h), (B, S, K, h), x.shape]
        assert kept[0].data_ptr() == x.data_ptr()
        plain = saved_activations(
            lambda: layers.normed_qkv(block["attn"], x, block["attn_norm"], cfg.norm_eps)[0])
        assert any(t.shape == x.shape and t.data_ptr() != x.data_ptr() for t in plain)

    def test_unknown_policy_raises(self):
        with pytest.raises(ValueError, match="remat_policy"):
            layers.remat_policy("everything")


# -------------------------------------------------------------- precision
class TestPrecision:
    def test_policies(self):
        assert MixedPrecisionPolicy.from_precision("bf16").compute_dtype == torch.bfloat16
        assert MixedPrecisionPolicy.from_precision(PrecisionType.NO).compute_dtype == torch.float32
        fp8 = MixedPrecisionPolicy.from_precision("fp8")
        assert fp8.compute_dtype == torch.bfloat16 and fp8.fp8
        assert not MixedPrecisionPolicy.from_precision("bf16").fp8
        with pytest.raises(NotImplementedError):
            MixedPrecisionPolicy.from_precision("fp16")
        with pytest.raises(ValueError):
            MixedPrecisionPolicy.from_precision("fp64")

    def test_cast_for_compute_keeps_ints_and_fp32_gradients(self):
        policy = MixedPrecisionPolicy.from_precision("bf16")
        w = torch.randn(4, 3, requires_grad=True)
        tree = policy.cast_for_compute({"w": [w], "ids": torch.arange(3)})
        assert tree["w"][0].dtype == torch.bfloat16 and tree["ids"].dtype == torch.int64
        tree["w"][0].float().sum().backward()
        assert w.grad.dtype == torch.float32

    def test_accumulation_plugin(self, monkeypatch):
        """The port has no launcher: a variable a JAX launch left behind
        changes neither the accumulation nor the precision."""
        monkeypatch.setenv("ATX_GRADIENT_ACCUMULATION_STEPS", "4")
        monkeypatch.setenv("ATX_MIXED_PRECISION", "bf16")
        assert GradientAccumulationPlugin().num_steps == 1
        assert GradientAccumulationPlugin(2).num_steps == 2
        with pytest.raises(ValueError, match=">= 1"):
            GradientAccumulationPlugin(0)
        acc = Accelerator(device="cpu")
        assert acc.gradient_accumulation_steps == 1 and acc.policy.compute_dtype == torch.float32


# --------------------------------------------------------------------- adamw
class TestAdamW:
    def test_matches_optax_over_three_updates(self):
        rng = np.random.default_rng(2)
        shapes = {"a": (5, 3), "b": (7,)}
        p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
        grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]
        tx = optax.adamw(1e-2)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        opt = tx.init(jp)
        for g in grads:
            upd, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, jp)
            jp = optax.apply_updates(jp, upd)
        tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p0.items()}
        topt = optim.adamw(1e-2).init(list(tp.values()))
        for g in grads:
            for k, p in tp.items():
                p.grad = torch.from_numpy(g[k])
            topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6)

    def test_defaults_are_optax(self):
        tx = optim.adamw(3e-4)
        assert (tx.b1, tx.b2, tx.eps, tx.weight_decay) == (0.9, 0.999, 1e-8, 1e-4)
        opt = tx.init([torch.zeros(2, requires_grad=True)])
        group = opt.param_groups[0]
        assert group["foreach"] and not group["fused"] and group["weight_decay"] == 1e-4

    def test_schedules_not_ported(self):
        with pytest.raises(NotImplementedError):
            optim.adamw(lambda step: 1e-3)


# ---------------------------------------------------------------- train step
CFG = llama.LlamaConfig.tiny()
CFG_J = jllama.LlamaConfig.tiny()


def _jax_run(params_np, batches, accum, **kw):
    acc = jacc.Accelerator(mixed_precision="no", seed=0, max_grad_norm=1.0,
                           gradient_accumulation_steps=accum, **kw)
    state = acc.create_train_state(jax.tree.map(jnp.asarray, params_np), optax.adamw(1e-3))
    step = acc.make_train_step(lambda p, b, r: jllama.loss_fn(p, b, CFG_J, r))
    metrics = []
    for tokens in batches:
        state, m = step(state, {"input_ids": jnp.asarray(tokens)})
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    return jax.tree.map(np.asarray, state.params), metrics


def _torch_run(params_np, batches, accum, **kw):
    acc = Accelerator(mixed_precision="no", seed=0, max_grad_norm=1.0,
                      gradient_accumulation_steps=accum, device="cpu", **kw)
    state = acc.create_train_state(params_from_jax(params_np, CFG, device="cpu"), optim.adamw(1e-3))
    step = acc.make_train_step(lambda p, b, g: llama.loss_fn(p, b, CFG, g))
    metrics = []
    for tokens in batches:
        state, m = step(state, {"input_ids": torch.from_numpy(tokens)})
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    assert state.step == len(batches)
    return {k: v.detach().numpy() for k, v in llama.flatten(state.params).items()}, metrics


def _assert_params_close(got, want_tree):
    for key, want in llama.flatten(want_tree).items():
        np.testing.assert_allclose(got[key], want, rtol=2e-5, atol=1e-4, err_msg=key)
        assert np.abs(got[key] - want).mean() < 1e-6, key


class TestTrainStep:
    @pytest.mark.parametrize("accum", [1, 2])
    def test_matches_jax_accelerator(self, accum):
        params_np = _weights(CFG, seed=5)
        batches = [_tokens(8, 16, CFG.vocab_size, 10 + i) for i in range(3)]
        jparams, jmetrics = _jax_run(params_np, batches, accum)
        tparams, tmetrics = _torch_run(params_np, batches, accum)
        np.testing.assert_allclose(np.array(tmetrics), np.array(jmetrics), rtol=1e-5)
        _assert_params_close(tparams, jparams)

    def test_clips_by_value_then_norm(self):
        params_np = _weights(CFG, seed=6)
        batches = [_tokens(8, 16, CFG.vocab_size, 20)]
        jparams, jmetrics = _jax_run(params_np, batches, 1, max_grad_value=1e-3)
        tparams, tmetrics = _torch_run(params_np, batches, 1, max_grad_value=1e-3)
        np.testing.assert_allclose(np.array(tmetrics), np.array(jmetrics), rtol=1e-5)
        _assert_params_close(tparams, jparams)

    def test_indivisible_batch_raises(self):
        acc = Accelerator(gradient_accumulation_steps=3, device="cpu")
        state = acc.create_train_state({"w": torch.zeros(2)}, optim.adamw(1e-3))
        step = acc.make_train_step(lambda p, b, g: (p["w"] * b["x"].sum()).sum())
        with pytest.raises(ValueError, match="not divisible"):
            step(state, {"x": torch.ones(4, 2)})

    def test_generator_per_microbatch(self):
        """Distinct draws per (step, microbatch), reproducible from the seed."""
        seen = []

        def loss(p, b, gen):
            seen.append(torch.rand((), generator=gen).item())
            return (p["w"] * b["x"]).sum()

        def run():
            acc = Accelerator(gradient_accumulation_steps=2, seed=7, device="cpu")
            state = acc.create_train_state({"w": torch.zeros(2)}, optim.adamw(1e-3))
            step = acc.make_train_step(loss)
            for _ in range(2):
                state, _ = step(state, {"x": torch.ones(4, 2)})

        run()
        first = list(seen)
        seen.clear()
        run()
        assert seen == first and len(set(first)) == 4

    def test_has_aux_and_bf16_loss_is_fp32(self):
        acc = Accelerator(mixed_precision="bf16", device="cpu")
        state = acc.create_train_state({"w": torch.ones(3)}, optim.adamw(1e-3))
        step = acc.make_train_step(lambda p, b, g: ((p["w"] * b["x"]).sum(), {"n": 1}), has_aux=True)
        state, metrics = step(state, {"x": torch.ones(2, 3)})
        assert metrics["loss"].dtype == torch.float32 and "grad_norm" not in metrics
        assert state.params["w"].dtype == torch.float32 and state.step == 1

    def test_global_norm_matches_jax(self):
        rng = np.random.default_rng(3)
        tree = {"a": rng.standard_normal((4, 5)).astype(np.float32), "b": rng.standard_normal(3).astype(np.float32)}
        want = float(jacc.global_norm(jax.tree.map(jnp.asarray, tree)))
        got = global_norm([torch.from_numpy(v) for v in tree.values()]).item()
        assert got == pytest.approx(want, rel=1e-6)

    def test_flash_train_step_counts_no_launch_on_cpu(self):
        cfg = llama.LlamaConfig.tiny(attention_impl="flash", remat=True, remat_policy="attn_and_outputs")
        acc = Accelerator(mixed_precision="bf16", seed=0, max_grad_norm=1.0, device="cpu")
        state = acc.create_train_state(lambda s: llama.init(cfg, seed=s, device="cpu"), optim.adamw(3e-4))
        step = acc.make_train_step(lambda p, b, g: llama.loss_fn(p, b, cfg, g))
        batch = {"input_ids": torch.from_numpy(_tokens(2, 32, cfg.vocab_size, 8))}
        before = dict(dispatch.launch_counts())
        losses = []
        for _ in range(3):
            state, m = step(state, batch)
            losses.append(m["loss"].item())
        assert losses[-1] < losses[0] and all(np.isfinite(losses))
        assert dispatch.launch_counts()["flash_attention_fwd"] == before.get("flash_attention_fwd", 0)
        assert fa.FWD_KERNEL.launches == before.get("flash_attention_fwd", 0)


# ----------------------------------------------------------------------- fp8
def _fp8_grads(cfg, params_np, tokens, *, jax_side=False):
    """Loss and gradients of `loss_fn` with every projection in fp8, fp32
    compute. The port's backward runs outside the fp8 context: the mode
    must have been captured by the forward (and the remat recompute)."""
    if jax_side:
        jcfg = jllama.LlamaConfig.tiny(remat=cfg.remat, remat_policy=cfg.remat_policy)

        def loss(p):
            with jfp8.fp8_matmuls(True):
                return jllama.loss_fn(p, {"input_ids": jnp.asarray(tokens)}, jcfg)

        value, grads = jax.jit(jax.value_and_grad(loss))(jax.tree.map(jnp.asarray, params_np))
        return float(value), {k: np.asarray(v) for k, v in llama.flatten(jax.device_get(grads)).items()}
    params = llama.nest({k: v.detach().clone().requires_grad_() for k, v in
                         llama.flatten(params_from_jax(params_np, cfg, device="cpu")).items()})
    with tfp8.fp8_matmuls():
        loss = llama.loss_fn(params, {"input_ids": torch.from_numpy(tokens)}, cfg)
    loss.backward()
    return loss.item(), {k: v.grad.numpy() for k, v in llama.flatten(params).items()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class TestFp8:
    POLICIES = ["attn_and_outputs", "block_outputs", "nothing", None]

    @pytest.mark.parametrize("policy", POLICIES, ids=[str(p) for p in POLICIES])
    def test_fp32_compute_loss_and_gradients_match_jax(self, policy):
        cfg = llama.LlamaConfig.tiny(remat=policy is not None, remat_policy=policy or "nothing")
        params_np = _weights(cfg, seed=5)
        tokens = _tokens(8, 16, cfg.vocab_size, 10)
        jloss, jgrads = _fp8_grads(cfg, params_np, tokens, jax_side=True)
        tloss, tgrads = _fp8_grads(cfg, params_np, tokens)
        assert tloss == pytest.approx(jloss, rel=1e-5)
        for key, want in jgrads.items():
            assert _rel(tgrads[key], want) < 1e-5, key

    @pytest.mark.parametrize("policy", ["attn_and_outputs", "block_outputs", "nothing"])
    def test_remat_recompute_runs_fp8(self, policy):
        """fp8 gradients with remat equal those without it (1e-6, the
        recompute repeats the forward's arithmetic). A recompute that ran
        bf16 or fp32 products where the forward ran fp8 ones would differ
        (or fail checkpoint's saved-tensor check)."""
        params_np = _weights(CFG, seed=7)
        tokens = _tokens(4, 16, CFG.vocab_size, 11)
        loss0, g0 = _fp8_grads(CFG, params_np, tokens)
        loss1, g1 = _fp8_grads(llama.LlamaConfig.tiny(remat=True, remat_policy=policy), params_np, tokens)
        assert loss1 == pytest.approx(loss0, rel=1e-6)
        for key in g0:
            np.testing.assert_allclose(g1[key], g0[key], rtol=1e-6, atol=1e-7, err_msg=key)

    @pytest.mark.parametrize("policy", ["attn_and_outputs", "nothing"])
    def test_train_step_matches_jax_accelerator(self, policy):
        jcfg = jllama.LlamaConfig.tiny(remat=True, remat_policy=policy)
        tcfg = llama.LlamaConfig.tiny(remat=True, remat_policy=policy)
        params_np = _weights(tcfg, seed=5)
        tokens = _tokens(8, 16, tcfg.vocab_size, 10)
        acc = jacc.Accelerator(mixed_precision="fp8", seed=0, max_grad_norm=1.0)
        state = acc.create_train_state(jax.tree.map(jnp.asarray, params_np), optax.adamw(1e-3))
        _, jm = acc.make_train_step(lambda p, b, r: jllama.loss_fn(p, b, jcfg, r))(
            state, {"input_ids": jnp.asarray(tokens)})
        policy_j = JaxPolicy.from_precision("fp8")

        def jloss(p):
            with jfp8.fp8_matmuls(True):
                return jllama.loss_fn(policy_j.cast_for_compute(p), {"input_ids": jnp.asarray(tokens)}, jcfg)

        jgrads = llama.flatten(jax.device_get(jax.grad(jloss)(jax.tree.map(jnp.asarray, params_np))))

        tacc = Accelerator(mixed_precision="fp8", seed=0, max_grad_norm=1.0, device="cpu")
        tstate = tacc.create_train_state(params_from_jax(params_np, tcfg, device="cpu"), optim.adamw(1e-3))
        tstate, tm = tacc.make_train_step(lambda p, b, g: llama.loss_fn(p, b, tcfg, g))(
            tstate, {"input_ids": torch.from_numpy(tokens)})
        assert tm["loss"].item() == pytest.approx(float(jm["loss"]), rel=1e-3)
        assert tm["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=2e-2)
        # The step leaves the clipped gradients on the masters.
        clip = min(1.0, 1.0 / (tm["grad_norm"].item() + 1e-6))
        for key, p in llama.flatten(tstate.params).items():
            assert _rel(p.grad.numpy() / clip, np.asarray(jgrads[key], np.float32)) < 0.3, key

    def test_dots_policy_raises(self):
        cfg = llama.LlamaConfig.tiny(remat=True, remat_policy="dots")
        acc = Accelerator(mixed_precision="fp8", device="cpu")
        state = acc.create_train_state(params_from_jax(_weights(cfg), cfg, device="cpu"), optim.adamw(1e-3))
        step = acc.make_train_step(lambda p, b, g: llama.loss_fn(p, b, cfg, g))
        with pytest.raises(NotImplementedError, match="dots"):
            step(state, {"input_ids": torch.from_numpy(_tokens(2, 16, cfg.vocab_size, 1))})

    def test_warns_when_no_projection_routes_through_fp8(self):
        acc = Accelerator(mixed_precision="fp8", device="cpu")
        state = acc.create_train_state({"w": torch.ones(3, 3)}, optim.adamw(1e-3))
        step = acc.make_train_step(lambda p, b, g: (b["x"] @ p["w"]).float().sum())
        with pytest.warns(UserWarning, match="no effect"):
            step(state, {"x": torch.ones(2, 3)})
        routed = acc.make_train_step(lambda p, b, g: tfp8.matmul_einsum("ij,jk->ik", b["x"], p["w"]).float().sum())
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("error")
            routed(state, {"x": torch.ones(2, 3)})
