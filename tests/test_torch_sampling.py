"""The port's sampling pipeline against the JAX package's, on the CPU.

Greedy rows and the candidate path (top-k / top-p / min-p with the murmur3 gumbel
draw) must give exactly the same tokens and logprobs (allclose 1e-5).  The
full-vocab path's reference draw is jax.random.categorical, which torch cannot
reproduce bit for bit: its tokens are checked against the distribution instead.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmdeploy_tpu.ops import sampling as js
from lmdeploy_tpu_torch.ops import sampling as ts

B, V = 16, 300


def make(rng, **over):
    base = dict(
        temperature=rng.uniform(0.5, 1.5, B).astype(np.float32),
        top_k=rng.choice([0, 1, 5, 40], B).astype(np.int32),
        top_p=rng.choice([1.0, 0.9, 0.5], B).astype(np.float32),
        min_p=rng.choice([0.0, 0.05], B).astype(np.float32),
        repetition_penalty=rng.choice([1.0, 1.3], B).astype(np.float32),
        frequency_penalty=rng.choice([0.0, 0.2], B).astype(np.float32),
        presence_penalty=rng.choice([0.0, 0.4], B).astype(np.float32),
        do_sample=rng.rand(B) < 0.75,
        seeds=rng.randint(0, 2 ** 32, B, dtype=np.uint64).astype(np.uint32),
        bad_words_mask=None, max_top_logprobs=3)
    base.update(over)
    jin = js.SamplingInputs(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                               for k, v in base.items()})
    tin = ts.SamplingInputs(**dict(base, seeds=base['seeds'].astype(np.int64))).to('cpu')
    return jin, tin


def run_both(rng, logits, counts, pmask, **kw):
    jin, tin = make(rng)
    jt, jlp, (jv, ji) = js.sample_logits(jnp.asarray(logits), jin, jnp.asarray(counts),
                                         jnp.asarray(pmask), **kw)
    tt, tlp, (tv, ti) = ts.sample_logits(torch.from_numpy(logits), tin,
                                         torch.from_numpy(counts), torch.from_numpy(pmask),
                                         **kw)
    return (np.asarray(jt), np.asarray(jlp), np.asarray(jv), np.asarray(ji)), \
        (tt.numpy(), tlp.numpy(), tv.numpy(), ti.numpy()), tin


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_candidate_path_exact_tokens(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    counts = rng.randint(0, 3, (B, V)).astype(np.int32) * (rng.rand(B, V) < 0.05)
    pmask = rng.rand(B, V) < 0.05
    j, t, _ = run_both(rng, logits, counts.astype(np.int32), pmask)
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_allclose(t[1], j[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t[3], j[3])


def test_hash_noise_bit_exact():
    seeds = np.array([0, 1, 2 ** 31 + 5, 2 ** 32 - 1], np.uint32)
    x = (seeds[:, None].astype(np.uint64) * 0x9E3779B9
         + np.arange(8, dtype=np.uint64)[None] * 0x85EBCA6B) & 0xFFFFFFFF
    for shift, mul in ((16, 0x7FEB352D), (15, 0x846CA68B)):
        x ^= x >> shift
        x = (x * mul) & 0xFFFFFFFF
    x ^= x >> 16
    ref = (x >> 8).astype(np.float32) * np.float32(1.0 / (1 << 24)) + np.float32(1e-12)
    out = ts.hash_uniform(torch.from_numpy(seeds.astype(np.int64)), 8).numpy()
    np.testing.assert_array_equal(out, ref)


def test_greedy_rows_exact_on_full_vocab_path():
    rng = np.random.RandomState(3)
    logits = (rng.randn(B, V) * 3).astype(np.float32)
    zeros = np.zeros((B, V), np.int32)
    j, t, tin = run_both(rng, logits, zeros, zeros.astype(bool), full_vocab=True)
    greedy = ~tin.do_sample.numpy()
    np.testing.assert_array_equal(t[0][greedy], j[0][greedy])
    np.testing.assert_allclose(t[1][greedy], j[1][greedy], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t[2], j[2], rtol=1e-5, atol=1e-5)


def test_full_vocab_samples_follow_the_distribution():
    """Many seeds on one row: empirical frequencies vs softmax(logits / T)."""
    rng = np.random.RandomState(4)
    n, v = 4000, 8
    logits = torch.from_numpy(rng.randn(1, v).astype(np.float32)).repeat(n, 1)
    inp = ts.SamplingInputs(
        temperature=torch.full((n,), 0.8), top_k=torch.zeros(n, dtype=torch.int32),
        top_p=torch.ones(n), min_p=torch.zeros(n), repetition_penalty=torch.ones(n),
        frequency_penalty=torch.zeros(n), presence_penalty=torch.zeros(n),
        do_sample=torch.ones(n, dtype=torch.bool),
        seeds=torch.arange(n, dtype=torch.int64) * 7919)
    toks, _, _ = ts.sample_logits(logits, inp, torch.zeros(n, v, dtype=torch.int32),
                                  full_vocab=True)
    freq = np.bincount(toks.numpy(), minlength=v) / n
    p = torch.softmax(logits[0] / 0.8, -1).numpy()
    # 4000 draws: a binomial standard error of at most 0.008 per token
    np.testing.assert_allclose(freq, p, atol=0.03)


def test_penalties_and_token_counts():
    rng = np.random.RandomState(5)
    logits = rng.randn(B, V).astype(np.float32)
    counts = rng.randint(0, 3, (B, V)).astype(np.int32)
    pmask = rng.rand(B, V) < 0.1
    jin, tin = make(rng)
    j = js.apply_penalties(jnp.asarray(logits), jnp.asarray(counts), jin, jnp.asarray(pmask))
    t = ts.apply_penalties(torch.from_numpy(logits), torch.from_numpy(counts), tin,
                           torch.from_numpy(pmask))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-6)
    toks = rng.randint(0, V, B).astype(np.int32)
    valid = rng.rand(B) < 0.5
    jc = js.update_token_counts(jnp.asarray(counts), jnp.asarray(toks), jnp.asarray(valid))
    tc = ts.update_token_counts(torch.from_numpy(counts.copy()), torch.from_numpy(toks),
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
