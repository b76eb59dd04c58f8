"""Port serving (`accelerate_tpu_torch.serving`) against the JAX package,
at `LlamaConfig.tiny` on the CPU in fp32.

The oracle is per request: every greedy completion the engine serves must
equal the port's batch-1 `generate` of that prompt, and the JAX model's
greedy continuation (one JAX `llama.generate`, plus a teacher-forced JAX
`forward` over every served sequence, where each generated token must be
the argmax, with a top-2 logit gap > 1e-3 so a near-tie cannot decide it).
The engine's batch-composition bit-identity is not an oracle here.

The prefix cache's radix tree is held against the JAX package's tree by
replaying one random sequence of operations through both.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu.models import llama as jllama
from accelerate_tpu.serving import engine as jengine
from accelerate_tpu.serving.prefix_cache import PrefixCache as JaxPrefixCache
from accelerate_tpu_torch import generation as tgen
from accelerate_tpu_torch.commands import serve
from accelerate_tpu_torch.models import llama as tllama
from accelerate_tpu_torch.models.convert import params_from_jax
from accelerate_tpu_torch.serving import Engine, PrefixCache, Request, default_buckets
from accelerate_tpu_torch.serving import poisson_trace, shared_prefix_trace

CFG_J = jllama.LlamaConfig.tiny()
CFG_T = tllama.LlamaConfig.tiny()
PAD_TO = 64  # every served prompt + completion fits; one JAX compile


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(1)
    flat = {}
    for key, shape in tllama.param_shapes(CFG_T).items():
        if key.endswith("norm"):
            std = 0.1
        elif key == "embed":
            std = 1.0
        else:
            std = (shape[1] if key.startswith("blocks") else shape[0]) ** -0.5
        flat[key] = (rng.standard_normal(shape) * std).astype(np.float32)
    np_params = tllama.nest(flat)
    return jax.tree.map(jnp.asarray, np_params), params_from_jax(np_params, CFG_T, device="cpu")


def _engine(tp, kv="fp32", **kw):
    gcfg = tgen.GenerationConfig(kv_cache_dtype=kv)
    return Engine(
        lambda p, t, c: tllama.forward_with_cache(p, t, c, CFG_T),
        lambda b, m: tllama.init_cache(CFG_T, b, m, tgen.cache_dtype(gcfg), device="cpu"),
        tp,
        gcfg,
        **{"slots": 3, "buckets": (8, 16), "max_len": PAD_TO, **kw},
    )


def _check_against_jax_forward(jp, completions):
    """Each generated token is the JAX model's argmax after its prefix, by a
    clear margin."""
    seqs = np.zeros((len(completions), PAD_TO), np.int32)
    spans = []
    for i, c in enumerate(completions):
        full = np.concatenate([c.prompt, c.tokens[: c.n_new]])
        seqs[i, : len(full)] = full
        spans.append((len(c.prompt), len(full)))
    logits = np.asarray(jax.jit(jllama.forward, static_argnums=2)(jp, jnp.asarray(seqs), CFG_J))
    for i, (start, end) in enumerate(spans):
        sl = logits[i, start - 1 : end - 1]
        np.testing.assert_array_equal(sl.argmax(-1), seqs[i, start:end])
        top2 = np.sort(sl, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > 1e-3


def _port_generate(tp, c):
    out = tllama.generate(
        tp, torch.from_numpy(c.prompt)[None], CFG_T,
        generation_config=tgen.GenerationConfig(max_new_tokens=c.n_new, kv_cache_dtype="fp32"),
    )
    return out[0, len(c.prompt):].numpy()


class TestEngineGreedy:
    @pytest.mark.parametrize("decode_block", [1, 4])
    def test_matches_generate_and_jax(self, weights, decode_block):
        jp, tp = weights
        trace = poisson_trace(
            6, 100.0, vocab_size=CFG_T.vocab_size, prompt_lens=(3, 30), new_tokens=(4, 10), seed=5
        )
        eng = _engine(tp, decode_block=decode_block)
        done = sorted(eng.serve(trace), key=lambda c: c.rid)
        assert [c.rid for c in done] == list(range(6))
        assert all(c.finish_reason == "length" and c.n_new == r.max_new_tokens
                   for c, r in zip(done, trace))
        for c in done:
            np.testing.assert_array_equal(c.tokens[: c.n_new], _port_generate(tp, c))
        _check_against_jax_forward(jp, done)
        assert eng.stats["completed"] == 6 and eng.stats["decode_steps"] > 0
        if decode_block == 1:
            c = done[0]
            jout = jllama.generate(
                jp, jnp.asarray(c.prompt)[None], CFG_J,
                generation_config=jgen.GenerationConfig(max_new_tokens=c.n_new, kv_cache_dtype="fp32"),
            )
            np.testing.assert_array_equal(c.tokens[: c.n_new], np.asarray(jout)[0, len(c.prompt):])

    def test_prefix_cache_hits_serve_the_same_tokens(self, weights):
        jp, tp = weights
        trace = shared_prefix_trace(
            6, 100.0, vocab_size=CFG_T.vocab_size, n_prefixes=2, prefix_len=16,
            tail_lens=(2, 9), new_tokens=(3, 8), seed=3,
        )
        eng = _engine(tp, slots=2)
        done = sorted(eng.serve(trace), key=lambda c: c.rid)
        metrics = eng.prefix_metrics()
        assert metrics["prefix_cache"] == 1 and metrics["prefill_tokens_saved"] > 0
        assert eng.stats["prefix_hits"] > 0 and eng.stats["prefix_copy_chunks"] > 0
        for c in done:
            np.testing.assert_array_equal(c.tokens[: c.n_new], _port_generate(tp, c))
        _check_against_jax_forward(jp, done)

    @pytest.mark.parametrize("kv", ["bf16", "int8"])
    def test_low_precision_caches_serve_every_request(self, weights, kv):
        _, tp = weights
        trace = poisson_trace(4, 100.0, vocab_size=CFG_T.vocab_size, prompt_lens=(3, 20),
                              new_tokens=(3, 6), seed=4)
        done = _engine(tp, kv=kv).serve(trace)
        assert sorted(c.rid for c in done) == [0, 1, 2, 3]
        assert all(c.n_new == r.max_new_tokens for c, r in zip(sorted(done, key=lambda c: c.rid), trace))

    def test_stop_sequence_and_eos(self, weights):
        _, tp = weights
        prompt = np.arange(5, 14, dtype=np.int32)
        ref = _engine(tp).serve([Request(prompt=prompt, max_new_tokens=8)])[0]
        toks = ref.tokens[: ref.n_new]
        eng = _engine(tp)
        eng.submit(prompt, 8, stop_sequences=[toks[2:4].tolist()])
        stop = eng.run_until_idle()[0]
        assert stop.finish_reason == "stop" and stop.n_new == 4
        eos_eng = _engine(tp)
        eos_eng.config = tgen.GenerationConfig(eos_token_id=int(toks[1]), kv_cache_dtype="fp32")
        eos_eng.submit(prompt, 8)
        eos = eos_eng.run_until_idle()[0]
        assert eos.finish_reason == "eos" and eos.n_new == 2

    def test_sampling_is_seeded_per_request(self, weights):
        _, tp = weights
        trace = lambda: poisson_trace(3, 100.0, vocab_size=CFG_T.vocab_size, prompt_lens=(3, 12),
                                      new_tokens=(4, 6), seed=6)
        runs = []
        for _ in range(2):
            eng = _engine(tp)
            eng.config = tgen.GenerationConfig(do_sample=True, top_k=16, kv_cache_dtype="fp32")
            runs.append({c.rid: c.tokens.tolist() for c in eng.serve(trace())})
        assert runs[0] == runs[1]

    def test_cancel_and_validation(self, weights):
        _, tp = weights
        eng = _engine(tp, slots=1)
        a = eng.submit(np.arange(1, 6), 5)
        b = eng.submit(np.arange(1, 6), 5)
        eng.step()  # a admitted and prefilled; b queued
        queued = eng.cancel(b)
        assert queued.finish_reason == "cancelled" and queued.n_new == 0
        running = eng.cancel(a)
        assert running.finish_reason == "cancelled" and running.n_new == 1
        assert not eng.busy and eng.cancel(a) is None
        with pytest.raises(ValueError, match="max_len"):
            eng.submit(np.arange(60), 10)
        with pytest.raises(ValueError, match="empty"):
            eng.submit(np.zeros(0), 3)


class TestTraces:
    def test_poisson_trace_matches_jax(self):
        port = poisson_trace(5, 4.0, vocab_size=100, seed=7)
        ref = jengine.poisson_trace(5, 4.0, vocab_size=100, seed=7)
        for p, r in zip(port, ref):
            np.testing.assert_array_equal(p.prompt, r.prompt)
            assert (p.max_new_tokens, p.arrival, p.seed) == (r.max_new_tokens, r.arrival, r.seed)

    def test_shared_prefix_trace_matches_jax(self):
        port = shared_prefix_trace(5, 4.0, vocab_size=100, seed=7)
        ref = jengine.shared_prefix_trace(5, 4.0, vocab_size=100, seed=7)
        for p, r in zip(port, ref):
            np.testing.assert_array_equal(p.prompt, r.prompt)
            assert p.max_new_tokens == r.max_new_tokens

    def test_default_buckets(self, monkeypatch):
        monkeypatch.delenv("ATX_SERVE_BUCKETS", raising=False)
        assert default_buckets() == jengine.default_buckets() == (32, 64, 128, 256)
        monkeypatch.setenv("ATX_SERVE_BUCKETS", "64,16,16")
        assert default_buckets() == (16, 64)
        monkeypatch.setenv("ATX_SERVE_BUCKETS", "a,b")
        with pytest.raises(ValueError):
            default_buckets()


class TestPrefixCacheTree:
    def test_replays_like_the_jax_tree(self):
        rng = np.random.default_rng(0)
        port, ref = PrefixCache(3, (4, 6), 32), JaxPrefixCache(3, (4, 6), 32)
        assert [port.aligned(n) for n in range(33)] == [ref.aligned(n) for n in range(33)]
        stems = [rng.integers(0, 5, 24).astype(np.int32) for _ in range(3)]
        pinned = []
        for _ in range(200):
            toks = stems[rng.integers(3)][: rng.integers(1, 25)].copy()
            if rng.random() < 0.2:
                toks[rng.integers(len(toks)) :] = rng.integers(0, 5)
            op = rng.random()
            if op < 0.45:
                n = port.aligned(len(toks))
                if n:
                    assert port.insert(toks[:n]) == ref.insert(toks[:n])
            elif op < 0.85 or not pinned:
                pn, pm = port.match(toks, limit=len(toks) - 1)
                rn, rm = ref.match(toks, limit=len(toks) - 1)
                assert pm == rm and (pn is None) == (rn is None)
                if pn is not None:
                    assert (pn.row, pn.end) == (rn.row, rn.end)
                    pinned.append((pn, rn))
            else:
                pn, rn = pinned.pop(rng.integers(len(pinned)))
                port.release(pn)
                ref.release(rn)
            assert port.used_rows == ref.used_rows
        assert dict(port.stats) == {k: ref.stats[k] for k in port.stats}
        with pytest.raises(RuntimeError, match="without a matching"):
            port.release(port._root)


class TestServeCommand:
    def test_cpu_run_prints_one_json_line(self, capsys):
        assert serve.main([
            "--model", "llama-tiny", "--device", "cpu", "--requests", "3",
            "--prompt-lens", "4:12", "--new-tokens", "2:4", "--kv-cache-dtype", "int8",
        ]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["serve_requests"] == 3 and line["device"] == "cpu"
        assert line["kv_cache_dtype"] == "int8" and line["serve_tokens_per_sec"] > 0

    def test_default_device_is_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main(["--model", "llama-tiny", "--requests", "1"])
