"""Port sampling (`accelerate_tpu_torch.generation.warp_logits`,
`sample_tokens`) against the JAX package, on the CPU, from the same numpy
logits: (2, 1000) fp32 from N(0, 9).

The kept sets (the finite entries of the warped logits) must be equal.
At ``top_p=1.0`` which of the least likely tokens are kept is decided by
the rounding of an fp32 cumsum that ends within a few 1e-7 of 1.0, summed
in another order by each framework: there the sets must be equal on every
token whose tail mass (its probability plus that of every less likely
token) exceeds V * 2^-24, the cumsum's rounding bound, and where the port's
cumsum never reaches ``top_p`` it must keep every token, as JAX's fill-mode
gather does, and not raise. Greedy draws must be equal; sampled draws come
from different generators, so each must lie in JAX's kept set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accelerate_tpu import generation as jgen
from accelerate_tpu_torch import generation as tgen

WARPS = [
    dict(top_p=0.9),
    dict(top_p=0.5),
    dict(top_k=50, top_p=0.9),
    dict(temperature=0.7, top_p=0.5),
]
FULL = [
    dict(top_p=1.0),
    dict(top_k=50, top_p=1.0),
    dict(temperature=0.7, top_p=1.0),
]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _logits(seed):
    return (np.random.default_rng(seed).standard_normal((2, 1000)) * 3.0).astype(np.float32)


def _kept(warped):
    return np.isfinite(np.asarray(warped))


@pytest.mark.parametrize("warp", WARPS, ids=lambda w: ",".join(f"{k}={v}" for k, v in w.items()))
@pytest.mark.parametrize("seed", range(4))
def test_warp_logits_keeps_what_jax_keeps(warp, seed):
    logits = _logits(seed)
    want = jgen.warp_logits(jnp.asarray(logits), jgen.GenerationConfig(**warp))
    got = tgen.warp_logits(torch.from_numpy(logits), tgen.GenerationConfig(**warp))
    np.testing.assert_array_equal(_kept(got), _kept(want))
    kept = _kept(want)
    np.testing.assert_allclose(got.numpy()[kept], np.asarray(want)[kept], rtol=1e-6)


def _tail_mass(logits, warp):
    """Each token's probability plus that of every less likely token under
    the warped distribution before the top-p cut, in float64."""
    x = logits.astype(np.float64) / warp.get("temperature", 1.0)
    if "top_k" in warp:
        kth = np.sort(x, -1)[:, -warp["top_k"]][:, None]
        x = np.where(x < kth, -np.inf, x)
    p = np.exp(x - x.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    order = np.argsort(-p, -1, kind="stable")
    tail = np.flip(np.cumsum(np.flip(np.take_along_axis(p, order, -1), -1), -1), -1)
    out = np.empty_like(tail)
    np.put_along_axis(out, order, tail, -1)
    return out


@pytest.mark.parametrize("warp", FULL, ids=lambda w: ",".join(f"{k}={v}" for k, v in w.items()))
@pytest.mark.parametrize("seed", range(4))
def test_top_p_one_keeps_what_jax_keeps_above_the_rounding_tail(warp, seed):
    logits = _logits(seed)
    want = _kept(jgen.warp_logits(jnp.asarray(logits), jgen.GenerationConfig(**warp)))
    got = _kept(tgen.warp_logits(torch.from_numpy(logits), tgen.GenerationConfig(**warp)))
    decided = _tail_mass(logits, warp) > logits.shape[-1] * 2.0**-24
    np.testing.assert_array_equal(got[decided], want[decided])


def test_top_p_one_keeps_every_token_where_the_cumsum_falls_short():
    """The fault this pins: an fp32 cumsum that never reaches 1.0 gave the
    index V, and the port's gather raised. Among these draws some rows must
    hit it, and each such row keeps all V tokens; so does JAX wherever its
    own cumsum never reaches 1.0."""
    short = 0
    cfg = tgen.GenerationConfig(top_p=1.0)
    for seed in range(20):
        logits = _logits(100 + seed)
        sorted_ = torch.sort(torch.from_numpy(logits), dim=-1, descending=True).values
        rows = (torch.softmax(sorted_, -1).cumsum(-1) < 1.0).all(-1).numpy()
        short += int(rows.sum())
        got = _kept(tgen.warp_logits(torch.from_numpy(logits), cfg))
        assert got[rows].all()
        jsorted = jnp.sort(jnp.asarray(logits), axis=-1)[..., ::-1]
        jrows = np.asarray((jnp.cumsum(jax.nn.softmax(jsorted, axis=-1), axis=-1) < 1.0).all(-1))
        want = _kept(jgen.warp_logits(jnp.asarray(logits), jgen.GenerationConfig(top_p=1.0)))
        assert want[jrows].all()
    assert short > 0


@pytest.mark.parametrize("warp", WARPS + FULL[:1], ids=lambda w: ",".join(f"{k}={v}" for k, v in w.items()))
def test_sample_tokens(warp):
    logits = _logits(7)
    greedy_t = tgen.sample_tokens(torch.from_numpy(logits), None, tgen.GenerationConfig())
    greedy_j = jgen.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0), jgen.GenerationConfig())
    np.testing.assert_array_equal(greedy_t.numpy(), np.asarray(greedy_j))
    assert greedy_t.dtype == torch.int32

    kept = _kept(jgen.warp_logits(jnp.asarray(logits), jgen.GenerationConfig(**warp)))
    kept |= _tail_mass(logits, warp) <= logits.shape[-1] * 2.0**-24 if warp["top_p"] == 1.0 else False
    gen = torch.Generator().manual_seed(0)
    cfg = tgen.GenerationConfig(do_sample=True, **warp)
    for _ in range(20):
        draw = tgen.sample_tokens(torch.from_numpy(logits), gen, cfg).numpy()
        assert draw.dtype == np.int32
        assert kept[np.arange(2), draw].all()
