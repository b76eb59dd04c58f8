"""Port of the offload-aware AdamW (`accelerate_tpu_torch.parallel.
host_offload`) and its `Accelerator` wiring against the JAX package, on the
CPU, from the same numpy inputs.

- `host_offloaded_adamw` against ``atx.host_offloaded_adamw`` and
  ``optax.adamw`` over 3 updates (the reference's
  `test_host_offloaded_adamw_matches_optax`): fp32, rtol 1e-6, atol 1e-7,
  the fused-AdamW tolerance (the same formula, an ulp apart where XLA
  fuses it); with a learning-rate schedule (optax's convention: the
  schedule sees the count of previous updates); with bf16 moments, one
  bf16 rounding (rtol 2^-8).
- The streamed (offloaded) update against the whole-tree update on CPU
  tensors, where the device is the host: bit-identical, the same
  elementwise arithmetic on the same elements.
- The train step with `host_offloaded_adamw(1e-3)`, with and without
  ``FsdpPlugin(offload_optimizer=True)``, with ``max_grad_norm``, against
  JAX's `Accelerator` with ``atx.host_offloaded_adamw(1e-3)`` on
  `LlamaConfig.tiny()` over 3 steps, at the step tolerances of
  `test_torch_train.py` (loss and grad norm 1e-5; params rtol 2e-5, atol
  1e-4, mean 1e-6: Adam divides by sqrt(v) ~ |g|, so an element with a
  near-zero gradient moves by ~lr on a gradient of large relative error).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import accelerate_tpu as atx
from accelerate_tpu.models import llama as jllama
from accelerate_tpu_torch import FsdpPlugin, host_offloaded_adamw, optim
from accelerate_tpu_torch.accelerator import Accelerator
from accelerate_tpu_torch.models import llama
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.native import dispatch
from accelerate_tpu_torch.parallel import host_offload
from accelerate_tpu_torch.utils.tree import flatten

TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _run_jax(tx, p0, grads):
    """Params and (mu, nu) after each update, through ``tx.update`` and
    ``optax.apply_updates``."""
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    out = []
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, upd)
        out.append({k: np.asarray(v) for k, v in params.items()})
    return out, state


def _run_port(tx, p0, grads, *, offload=False, names=None, grad_scale=None):
    params = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in p0.items()}
    opt = tx.init(list(params.values()), names or list(params), offload=offload)
    out = []
    for g in grads:
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step(grad_scale=grad_scale)
        out.append({k: p.detach().clone().numpy() for k, p in params.items()})
    return out, opt, params


def _tree(shapes, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"w": (64,), "b": (5, 3)}


class TestHostOffloadedAdamW:
    def test_matches_atx_host_offloaded_adamw_and_optax(self):
        p0 = _tree(SHAPES, 0)
        grads = [_tree(SHAPES, 1 + i) for i in range(3)]
        port, opt, params = _run_port(host_offloaded_adamw(1e-3), p0, grads)
        for tx in (atx.host_offloaded_adamw(1e-3), optax.adamw(1e-3)):
            want, _ = _run_jax(tx, p0, grads)
            for got_step, want_step in zip(port, want):
                for k in SHAPES:
                    np.testing.assert_allclose(got_step[k], want_step[k], err_msg=k, **TOL)
        _, jstate = _run_jax(atx.host_offloaded_adamw(1e-3), p0, grads)
        assert opt.count == int(jstate["count"]) == 3
        for k, p in params.items():
            for m in ("mu", "nu"):
                np.testing.assert_allclose(opt.state[p][m].numpy(), np.asarray(jstate[m][k]), **TOL)

    def test_defaults_are_jax(self):
        tx = host_offloaded_adamw(3e-4)
        assert (tx.b1, tx.b2, tx.eps, tx.weight_decay, tx.mu_dtype, tx.stacked_paths) == (
            0.9, 0.999, 1e-8, 1e-4, None, ("blocks",))
        assert isinstance(tx.init([torch.zeros(2, requires_grad=True)]), torch.optim.Optimizer)

    def test_schedule_sees_the_count_of_previous_updates(self):
        p0 = _tree(SHAPES, 2)
        grads = [_tree(SHAPES, 3 + i) for i in range(4)]
        seen = []

        def schedule(count):  # optax.linear_schedule(1e-2, 1e-3, 3)
            seen.append(count)
            return 1e-2 + (1e-3 - 1e-2) * min(count, 3) / 3

        port, _, _ = _run_port(host_offloaded_adamw(schedule), p0, grads)
        for tx in (atx.host_offloaded_adamw(optax.linear_schedule(1e-2, 1e-3, 3)),
                   optax.adamw(optax.linear_schedule(1e-2, 1e-3, 3))):
            want, _ = _run_jax(tx, p0, grads)
            for got_step, want_step in zip(port, want):
                for k in SHAPES:
                    np.testing.assert_allclose(got_step[k], want_step[k], err_msg=k, **TOL)
        assert seen == [0, 1, 2, 3]

    def test_bf16_moments(self):
        p0 = _tree(SHAPES, 4)
        grads = [_tree(SHAPES, 5 + i) for i in range(3)]
        port, opt, params = _run_port(host_offloaded_adamw(1e-3, mu_dtype=torch.bfloat16), p0, grads)
        want, jstate = _run_jax(atx.host_offloaded_adamw(1e-3, mu_dtype=jnp.bfloat16), p0, grads)
        for got_step, want_step in zip(port, want):
            for k in SHAPES:
                np.testing.assert_allclose(got_step[k], want_step[k], rtol=2.0**-8, atol=1e-7, err_msg=k)
        for k, p in params.items():
            assert opt.state[p]["mu"].dtype == torch.bfloat16
            for m in ("mu", "nu"):
                np.testing.assert_allclose(opt.state[p][m].float().numpy(),
                                           np.asarray(jstate[m][k].astype(jnp.float32)), rtol=2.0**-8, atol=1e-7)


# Layer-stacked leaves under "blocks" (a 1-D "blocks" leaf is not stacked:
# the layer axis must lead a leaf of rank >= 2) and whole leaves besides.
TREE = {"blocks.w": (3, 4, 5), "blocks.norm": (3, 4), "blocks.scalar": (3,), "embed": (7, 4), "norm": (4,)}


class TestStreamedUpdate:
    @pytest.mark.parametrize("mu_dtype", [None, torch.bfloat16], ids=["mu_fp32", "mu_bf16"])
    @pytest.mark.parametrize("with_scale", [False, True])
    def test_streamed_equals_whole_tree_bitwise(self, mu_dtype, with_scale):
        p0 = _tree(TREE, 6)
        grads = [_tree(TREE, 7 + i, 1e-2) for i in range(3)]
        tx = host_offloaded_adamw(1e-3, mu_dtype=mu_dtype)
        scale = torch.tensor(0.25) if with_scale else None
        whole, opt_w, params_w = _run_port(tx, p0, grads, grad_scale=scale)
        streamed, opt_s, params_s = _run_port(tx, p0, grads, offload=True, grad_scale=scale)
        assert opt_s.offload and not opt_w.offload
        for a, b in zip(whole, streamed):
            for k in TREE:
                assert np.array_equal(a[k], b[k]), k
        for k in TREE:
            for m in ("mu", "nu"):
                assert torch.equal(opt_w.state[params_w[k]][m], opt_s.state[params_s[k]][m]), (k, m)

    def test_stacked_leaves_go_one_layer_slice_at_a_time(self, monkeypatch):
        calls = []
        real = host_offload.fused_adamw

        def spy(g, mu, nu, p, *args, **kwargs):
            calls.append(tuple(p.shape))
            return real(g, mu, nu, p, *args, **kwargs)

        monkeypatch.setattr(host_offload, "fused_adamw", spy)
        _run_port(host_offloaded_adamw(1e-3), _tree(TREE, 8), [_tree(TREE, 9)], offload=True)
        # The first whole leaf, the layer slices, the other whole leaves.
        assert calls == [(3,)] + [(4, 5)] * 3 + [(4,)] * 3 + [(7, 4), (4,)]
        calls.clear()
        _run_port(host_offloaded_adamw(1e-3), _tree(TREE, 8), [_tree(TREE, 9)])
        assert calls == list(TREE.values())

    def test_moments_live_on_the_host(self):
        _, opt, params = _run_port(host_offloaded_adamw(1e-3), _tree(TREE, 10), [_tree(TREE, 11)], offload=True)
        for k, p in params.items():
            for m in ("mu", "nu"):
                t = opt.state[p][m]
                # The device is the host here: plain CPU tensors, never pinned
                # (a CPU-only torch cannot pin).
                assert t.device.type == "cpu" and t.shape == p.shape and t.dtype == torch.float32
        assert [host_offload.is_stacked(k, p, ("blocks",)) for k, p in params.items()] == [
            True, True, False, False, False]

    def test_warns_past_the_unstacked_bytes(self, monkeypatch):
        params = [torch.zeros(8, 8, requires_grad=True), torch.zeros(2, 8, 8, requires_grad=True)]
        monkeypatch.setattr(host_offload, "UNSTACKED_WARN_BYTES", 500)
        with pytest.warns(UserWarning, match="stacked_paths"):
            host_offloaded_adamw(1e-3).init(params, ["embed", "blocks.w"], offload=True)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            host_offloaded_adamw(1e-3).init(params, ["embed", "blocks.w"], offload=False)
            host_offloaded_adamw(1e-3).init(params[1:], ["blocks.w"], offload=True)

    def test_no_launch_on_the_cpu(self):
        before = dispatch.launch_counts().get("fused_adamw", 0)
        _run_port(host_offloaded_adamw(1e-3), _tree(TREE, 12), [_tree(TREE, 13)], offload=True)
        assert dispatch.launch_counts()["fused_adamw"] == before


# ---------------------------------------------------------------- train step
CFG = llama.LlamaConfig.tiny()
CFG_J = jllama.LlamaConfig.tiny()


def _weights(cfg, seed):
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in llama.param_shapes(cfg).items():
        fan_in = shape[1] if key.startswith("blocks") else shape[0]
        std = 0.1 if key.endswith("norm") else (1.0 if key == "embed" else fan_in**-0.5)
        flat[key] = (rng.standard_normal(shape) * std).astype(np.float32)
    return llama.nest(flat)


def _batches():
    return [np.random.default_rng(30 + i).integers(0, CFG.vocab_size, (8, 16)).astype(np.int32) for i in range(3)]


class TestTrainStep:
    @pytest.mark.parametrize("offload", [False, True], ids=["device_resident", "offloaded"])
    def test_matches_jax_accelerator(self, offload):
        params_np = _weights(CFG, 5)
        jacc = atx.Accelerator(mixed_precision="no", seed=0, max_grad_norm=1.0)
        jstate = jacc.create_train_state(jax.tree.map(jnp.asarray, params_np), atx.host_offloaded_adamw(1e-3))
        jstep = jacc.make_train_step(lambda p, b, r: jllama.loss_fn(p, b, CFG_J, r))
        acc = Accelerator(mixed_precision="no", seed=0, max_grad_norm=1.0, device="cpu",
                          strategy=FsdpPlugin(offload_optimizer=offload))
        state = acc.create_train_state(params_from_jax(params_np, CFG, device="cpu"), host_offloaded_adamw(1e-3))
        assert state.opt_state.offload == offload
        step = acc.make_train_step(lambda p, b, g: llama.loss_fn(p, b, CFG, g))
        for tokens in _batches():
            jstate, jm = jstep(jstate, {"input_ids": jnp.asarray(tokens)})
            state, m = step(state, {"input_ids": torch.from_numpy(tokens)})
            np.testing.assert_allclose([m["loss"].item(), m["grad_norm"].item()],
                                       [float(jm["loss"]), float(jm["grad_norm"])], rtol=1e-5)
        got = {k: v.detach().numpy() for k, v in flatten(state.params).items()}
        for key, want in llama.flatten(jax.device_get(jstate.params)).items():
            np.testing.assert_allclose(got[key], want, rtol=2e-5, atol=1e-4, err_msg=key)
            assert np.abs(got[key] - want).mean() < 1e-6, key
        assert state.opt_state.count == 3

    def test_offloaded_step_equals_device_resident_step_bitwise(self):
        params_np = _weights(CFG, 6)
        runs = []
        for offload in (False, True):
            acc = Accelerator(mixed_precision="bf16", seed=0, max_grad_norm=1.0, device="cpu",
                              strategy=FsdpPlugin(offload_optimizer=offload))
            state = acc.create_train_state(params_from_jax(params_np, CFG, device="cpu"),
                                           host_offloaded_adamw(1e-3))
            step = acc.make_train_step(lambda p, b, g: llama.loss_fn(p, b, CFG, g))
            for tokens in _batches():
                state, _ = step(state, {"input_ids": torch.from_numpy(tokens)})
            runs.append(state)
        a, b = runs
        for (k, pa), pb in zip(flatten(a.params).items(), flatten(b.params).values()):
            assert torch.equal(pa, pb), k
            for m in ("mu", "nu"):
                assert torch.equal(a.opt_state.state[pa][m], b.opt_state.state[pb][m]), (k, m)

    def test_the_clip_is_folded_into_the_update(self):
        """The step passes the clip as ``grad_scale`` and leaves the
        gradients unscaled (`optim.adamw` still gets clipped gradients)."""
        acc = Accelerator(seed=0, max_grad_norm=1e-3, device="cpu")
        state = acc.create_train_state({"w": torch.ones(3)}, host_offloaded_adamw(1e-3))
        step = acc.make_train_step(lambda p, b, g: (p["w"] * b["x"]).sum())
        state, m = step(state, {"x": torch.full((2, 3), 2.0)})
        assert torch.equal(state.params["w"].grad, torch.full((3,), 4.0))
        assert m["grad_norm"].item() == pytest.approx(4.0 * 3**0.5)
        state = acc.create_train_state({"w": torch.ones(3)}, optim.adamw(1e-3))
        state, m = acc.make_train_step(lambda p, b, g: (p["w"] * b["x"]).sum())(state, {"x": torch.full((2, 3), 2.0)})
        assert state.params["w"].grad.norm().item() == pytest.approx(1e-3, rel=1e-4)


class TestGuards:
    def test_offload_with_a_plain_optimizer_raises(self):
        acc = Accelerator(device="cpu", strategy=FsdpPlugin(offload_optimizer=True))
        with pytest.raises(ValueError, match="host_offloaded_adamw"):
            acc.create_train_state({"w": torch.zeros(2)}, optim.adamw(1e-3))

    def test_fsdp_plugin_reads_no_environment(self, monkeypatch):
        monkeypatch.setenv("ATX_OFFLOAD_OPTIMIZER", "1")
        monkeypatch.setenv("ATX_FSDP_STATE_DICT_TYPE", "FULL_STATE_DICT")
        plugin = FsdpPlugin()
        assert (plugin.offload_optimizer, plugin.state_dict_type, plugin.min_weight_size) == (
            False, "SHARDED_STATE_DICT", 2**11)
        acc = Accelerator(device="cpu", strategy=plugin)
        state = acc.create_train_state({"w": torch.zeros(2)}, host_offloaded_adamw(1e-3))
        assert not state.opt_state.offload
