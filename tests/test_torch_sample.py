"""Port parity: sampled requests — the threefry PRNG (`repro_torch.serve.prng`),
the sampler and the scheduler's sampled path — against `jax.random` and
`repro.serve`.

Keys, random bits and uniforms are integer-equal to JAX (threefry2x32 on
the partitionable path), including seeds and fold-in data at or above
2**31 and the Random123 known-answer vectors.  Gumbel noise goes through
`log`, whose last bit may differ between XLA and torch, so categorical
draws are held equal on fixed logits (a flip needs a near-tie within an
ulp).  Token streams of a mixed greedy / sampled workload equal the
reference `Scheduler`'s (prefix sharing and async admission off) on the
reduced qwen2-0.5b in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro.configs.base import load_arch as jload_arch
from repro.models import zoo as jzoo
from repro.serve import sampler as jsampler
from repro_torch import serve
from repro_torch.configs.base import load_arch
from repro_torch.convert import params_from_numpy
from repro_torch.serve import prng, sampler
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEEDS = (0, 7, 2**31 - 1, 2**31, 2**31 + 5, 2**32 - 1, 2**32 + 7)
DATA = (0, 1, 12345, 2**31 - 1, 2**31, 2**32 - 1)
SCHED = dict(max_slots=2, max_seq=64, page=16, decode_chunk=4)

# Random123's threefry2x32 known-answer vectors (key, counter, output)
KAT = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
       ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
       ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0))]


def _key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).astype(np.int64)


@pytest.mark.parametrize("key,ctr,want", KAT)
def test_threefry2x32_known_answers(key, ctr, want):
    t = [torch.tensor(v, dtype=torch.int64) for v in (*key, *ctr)]
    assert tuple(int(v) for v in prng.threefry2x32(*t)) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_integer_equal(seed):
    key = prng.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), _key(seed))
    jkey = jax.random.PRNGKey(seed)
    want = np.stack([np.asarray(jax.random.fold_in(jkey, np.uint32(d))) for d in DATA])
    got = prng.fold_in(key, torch.tensor(DATA, dtype=torch.int64))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # negative int32 data wraps to uint32 as jnp.uint32 wraps it
    np.testing.assert_array_equal(
        prng.fold_in(key, -5).numpy(),
        np.asarray(jax.random.fold_in(jkey, jnp.int32(-5))).astype(np.int64))


@pytest.mark.parametrize("n", [1, 2, 5, 512, 4099])
def test_random_bits_and_uniform_integer_equal(n):
    jkeys = [jax.random.fold_in(jax.random.PRNGKey(s), g) for s, g in ((0, 3), (2**31 + 1, 9))]
    keys = torch.from_numpy(np.stack([np.asarray(k) for k in jkeys]).astype(np.int64))
    want = np.stack([np.asarray(jax.random.bits(k, (n,), jnp.uint32)) for k in jkeys])
    np.testing.assert_array_equal(prng.random_bits(keys, n).numpy(), want.astype(np.int64))
    want_u = np.stack([np.asarray(jax.random.uniform(k, (n,))) for k in jkeys])
    got_u = prng.uniform(keys, n).numpy()
    assert got_u.dtype == np.float32
    np.testing.assert_array_equal(got_u.view(np.int32), want_u.view(np.int32))
    # one value per key: JAX's shape-() draw (counter 0)
    want_s = np.stack([np.asarray(jax.random.uniform(k)) for k in jkeys])
    np.testing.assert_array_equal(prng.uniform(keys).numpy(), want_s)


def test_categorical_draws_equal_on_fixed_logits():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(64, 3000)) * 2).astype(np.float32)
    seeds = np.arange(64, dtype=np.int32) * 977
    gens = rng.integers(0, 200, 64).astype(np.int32)
    base = jax.random.PRNGKey(0)
    jkeys = jsampler.fold_keys(base, jnp.asarray(seeds), jnp.asarray(gens))
    keys = sampler.fold_keys(prng.PRNGKey(0), torch.from_numpy(seeds),
                             torch.from_numpy(gens))
    np.testing.assert_array_equal(keys.numpy(), np.asarray(jkeys).astype(np.int64))
    want = np.asarray(jax.vmap(jax.random.categorical)(jkeys, jnp.asarray(logits)))
    got = prng.categorical(keys, torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(got, want)
    # Gumbel noise itself: equal up to the last bit of `log`
    jg = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (3000,)))(jkeys))
    np.testing.assert_allclose(prng.gumbel(keys, 3000).numpy(), jg, rtol=2e-6, atol=2e-6)


def _mask_case(name):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(6, 300)) * 3).astype(np.float32)
    top_k = np.zeros(6, np.int32)
    top_p = np.zeros(6, np.float32)
    if name == "top_k":
        top_k[:] = (1, 16, 299, 300, 400, 5)
    elif name == "top_p":
        top_p[:] = (0.1, 0.5, 0.9, 0.99, 1.0, -1.0)
    elif name == "ties":
        logits[:, :12] = 4.0                 # twelve tied maxima
        logits[:, 12:20] = 3.0               # and a tied second level
        top_k[:] = (1, 5, 12, 14, 0, 0)      # cutoffs inside the tied runs
        top_p[:] = (0, 0, 0, 0, 0.3, 0.95)
    elif name == "both":
        top_k[:] = (16, 16, 3, 50, 0, 8)
        top_p[:] = (0.5, 0.9, 0.9, 0.2, 0.7, 1.5)
    return logits, top_k, top_p


@pytest.mark.parametrize("name", ["disabled", "top_k", "top_p", "ties", "both"])
def test_mask_logits_matches(name):
    logits, top_k, top_p = _mask_case(name)
    want = np.asarray(jsampler.mask_logits(jnp.asarray(logits), jnp.asarray(top_k),
                                           jnp.asarray(top_p)))
    got = sampler.mask_logits(torch.from_numpy(logits), torch.from_numpy(top_k),
                              torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "disabled":
        np.testing.assert_array_equal(got, logits)


def test_sample_matches():
    logits, top_k, top_p = _mask_case("both")
    temp = np.array([0.0, 0.8, 1.3, 0.5, 0.0, 2.0], np.float32)
    seeds = np.arange(6, dtype=np.int32) + 40
    gens = np.arange(6, dtype=np.int32) * 3
    jkeys = jsampler.fold_keys(jax.random.PRNGKey(5), jnp.asarray(seeds), jnp.asarray(gens))
    want = np.asarray(jsampler.sample(jkeys, jnp.asarray(logits), jnp.asarray(temp),
                                      jnp.asarray(top_k), jnp.asarray(top_p)))
    keys = sampler.fold_keys(prng.PRNGKey(5), torch.from_numpy(seeds), torch.from_numpy(gens))
    got = sampler.sample(keys, torch.from_numpy(logits), torch.from_numpy(temp),
                         torch.from_numpy(top_k), torch.from_numpy(top_p))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # greedy lanes take the argmax
    assert int(got[0]) == int(np.argmax(logits[0]))


# ---------------------------------------------------------------------------
# the sampled scheduler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = jload_arch("qwen2_0_5b").reduced()
    cfg = load_arch("qwen2_0_5b").reduced()
    packed = jax.jit(jzoo.pack_params, static_argnums=0)(
        jcfg, jax.jit(jzoo.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, packed), "cpu")
    return jcfg, cfg, packed, model


def _workload(mod, vocab, n=7):
    """examples/serve_hinm.py's mix: every fourth request sampled at
    temperature 0.8 and top-k 16, the rest greedy; one nucleus request and
    one explicit seed besides; staggered arrivals over two length buckets."""
    rng = np.random.default_rng(11)
    reqs = []
    for i in range(n):
        p = mod.SamplingParams(max_new_tokens=10 if i % 3 == 0 else 6,
                               temperature=0.8 if i % 4 == 3 else 0.0,
                               top_k=16 if i % 4 == 3 else 0)
        if i == 1:
            p.temperature, p.top_p = 1.1, 0.9
        if i == 5:
            p.temperature, p.seed = 0.6, 2**31 - 9
        reqs.append(mod.Request(rid=i, prompt=rng.integers(0, vocab, (4 + 2 * i,)).astype(
            np.int32), params=p, arrival=i))
    return reqs


@pytest.fixture(scope="module")
def reference_streams(setup):
    """The reference scheduler's streams, once per policy (one scheduler,
    reset and switched to the static policy for the second run)."""
    jcfg, cfg, packed, _ = setup
    sched = jserve.Scheduler(jcfg, packed, prefix_share=False, async_admission=False,
                             **SCHED)
    out = {}
    for policy in ("continuous", "static"):
        sched.reset()
        sched.policy = policy
        reqs = _workload(jserve, cfg.vocab)
        sched.run(reqs)
        out[policy] = [r.tokens for r in reqs]
    return out


@pytest.mark.parametrize("policy", ["continuous", "static"])
def test_sampled_streams_equal_reference(setup, reference_streams, policy):
    _, cfg, _, model = setup
    sched = serve.Scheduler(cfg, model, policy=policy, prefix_share=False,
                            async_admission=False, device="cpu", **SCHED)
    reqs = _workload(serve, cfg.vocab)
    sched.run(reqs)
    assert [r.tokens for r in reqs] == reference_streams[policy]
    assert all(r.n_generated == r.params.max_new_tokens for r in reqs)


def test_sampled_stream_independent_of_slot_and_neighbours(setup, reference_streams):
    """A sampled request's stream depends on its seed and token index only:
    alone in a one-slot pool it emits what it emitted in the busy pool."""
    _, cfg, _, model = setup
    busy = _workload(serve, cfg.vocab)
    for rid in (1, 3, 5):
        req = busy[rid]
        req.arrival = 0
        serve.Scheduler(cfg, model, prefix_share=False, async_admission=False,
                        device="cpu", **dict(SCHED, max_slots=1)).run([req])
        assert req.tokens == reference_streams["continuous"][rid]


def test_sampled_engine_and_rng_seed(setup):
    """`ServeEngine(temperature=...)`: a sampled batch through the facade;
    the same rng_seed repeats the batch, another one changes it."""
    _, cfg, _, model = setup
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    eng = serve.ServeEngine(cfg, model, max_seq=64, temperature=0.9, top_k=32,
                            decode_chunk=4, page=16, device="cpu")
    a, stats = eng.generate(prompts, max_new_tokens=8, rng_seed=3)
    b, _ = eng.generate(prompts, max_new_tokens=8, rng_seed=3)
    c, _ = eng.generate(prompts, max_new_tokens=8, rng_seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert stats.requests_finished == 2 and ((a >= 0) & (a < cfg.vocab)).all()
