"""The port's rejection sampler (``ops/spec_sampling.py``) against the JAX package's.

Its deterministic outputs must equal the reference's exactly: identical distributions
accept every draft token, disjoint ones reject the first, and one-hot (greedy)
distributions give the same emitted count and tokens.  With planted uniforms it must
follow the rule as written, to the token; its own draws must reproduce the target's
distribution (a chi-square test over 24,000 rows); ``expected_acceptance_rate`` is
allclose in f32.  The speculative step's row advance is held against a plain loop.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _both(target, draft, tokens, seed=0):
    from lmdeploy_tpu.ops.spec_sampling import reject_sample as jrs
    from lmdeploy_tpu_torch.ops.spec_sampling import reject_sample as trs
    jo, jn = jrs(jnp.asarray(target), jnp.asarray(draft), jnp.asarray(tokens),
                 jax.random.PRNGKey(seed))
    seeds = torch.arange(target.shape[0], dtype=torch.int64) * 7919 + seed
    to, tn = trs(torch.from_numpy(target), torch.from_numpy(draft), torch.from_numpy(tokens),
                 seeds)
    return np.asarray(jo), np.asarray(jn), to.numpy(), tn.numpy()


def test_identical_distributions_accept_all():
    B, K, V = 4, 3, 16
    rng = np.random.RandomState(0)
    probs = _softmax(rng.randn(B, K + 1, V))
    tokens = rng.randint(0, V, (B, K)).astype(np.int32)
    jo, jn, to, tn = _both(probs, probs[:, :K], tokens)
    assert (tn == K + 1).all() and (jn == tn).all()
    np.testing.assert_array_equal(to[:, :K], jo[:, :K])
    np.testing.assert_array_equal(to[:, :K], tokens)


def test_disjoint_distributions_reject_first():
    B, K, V = 2, 2, 8
    target = np.zeros((B, K + 1, V), np.float32)
    target[..., :4] = 0.25
    draft = np.zeros((B, K, V), np.float32)
    draft[..., 4:] = 0.25
    tokens = np.full((B, K), 5, np.int32)
    jo, jn, to, tn = _both(target, draft, tokens, seed=1)
    assert (tn == 1).all() and (jn == tn).all()
    assert (to[:, 0] < 4).all() and (jo[:, 0] < 4).all()


@pytest.mark.parametrize('seed', range(4))
def test_one_hot_outputs_equal_jax(seed):
    """Greedy rows (one-hot target and draft): the accepted prefix, the emitted count
    and every valid token equal the reference's, a row that accepts all included."""
    B, K, V = 16, 4, 32
    rng = np.random.RandomState(seed)
    tgt_ids = rng.randint(0, V, (B, K + 1))
    tokens = tgt_ids[:, :K].copy()
    # row b agrees with the target on its first b % (K + 1) proposals
    for b in range(B):
        n = b % (K + 1)
        tokens[b, n:] = (tgt_ids[b, n:K] + 1 + rng.randint(0, V - 1, K - n)) % V
    tokens = tokens.astype(np.int32)
    target = np.eye(V, dtype=np.float32)[tgt_ids]
    draft = np.eye(V, dtype=np.float32)[tokens]
    jo, jn, to, tn = _both(target, draft, tokens, seed)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tn, np.arange(B) % (K + 1) + 1)
    for b in range(B):
        np.testing.assert_array_equal(to[b, :tn[b]], jo[b, :jn[b]])
        np.testing.assert_array_equal(to[b, :tn[b]], tgt_ids[b, :tn[b]])
        assert (to[b, tn[b]:] == to[b, tn[b] - 1]).all()     # padded with the extra token


def _rule(target, draft, tokens, u_acc, u_res, u_bon):
    """The rule as written, row by row in numpy (the draw: gumbel-max over log p)."""
    B, K1, V = target.shape
    K = K1 - 1
    out = np.zeros((B, K1), np.int64)
    n = np.zeros(B, np.int64)
    with np.errstate(divide='ignore'):
        for b in range(B):
            acc = 0
            while acc < K:
                d = tokens[b, acc]
                ratio = np.float32(target[b, acc, d]) / max(np.float32(draft[b, acc, d]),
                                                            np.float32(1e-20))
                if not u_acc[b, acc] < min(ratio, np.float32(1.0)):
                    break
                acc += 1
            if acc == K:
                p, u = target[b, K], u_bon[b]
            else:
                res = np.maximum(target[b, acc] - draft[b, acc], 0)
                s = res.sum()
                p, u = (res / max(s, 1e-20) if s > 1e-20 else target[b, acc]), u_res[b]
            extra = np.argmax(np.log(p) - np.log(-np.log(u)))
            out[b, :acc] = tokens[b, :acc]
            out[b, acc:] = extra
            n[b] = acc + 1
    return out, n


def test_planted_uniforms_follow_the_rule():
    """All accepted, first rejected and partial rows, a degenerate residual, against the
    rule in plain numpy, token for token."""
    from lmdeploy_tpu_torch.ops.spec_sampling import reject_sample
    B, K, V = 64, 4, 24
    rng = np.random.RandomState(5)
    target = _softmax(rng.randn(B, K + 1, V) * 2)
    draft = _softmax(rng.randn(B, K, V) * 2)
    draft[:8] = target[:8, :K]                     # identical rows: every proposal accepted
    tokens = np.stack([[rng.choice(V, p=draft[b, i]) for i in range(K)]
                       for b in range(B)]).astype(np.int32)
    u_acc = rng.uniform(1e-6, 1, (B, K)).astype(np.float32)
    u_acc[8:16] = 1e-7                            # accept nearly everything
    u_acc[16:24, 0] = 0.999999                    # reject the first
    # unnormalized drafts at twice the target: rejected at ratio 0.5 with a residual of
    # no mass, which falls back to the target
    draft[24:32] = 2 * target[24:32, :K]
    u_acc[24:32, 0] = 0.9
    u_res = rng.uniform(1e-6, 1, (B, V)).astype(np.float32)
    u_bon = rng.uniform(1e-6, 1, (B, V)).astype(np.float32)
    out, n = reject_sample(torch.from_numpy(target), torch.from_numpy(draft),
                           torch.from_numpy(tokens),
                           uniforms=tuple(map(torch.from_numpy, (u_acc, u_res, u_bon))))
    ref_out, ref_n = _rule(target, draft, tokens, u_acc, u_res, u_bon)
    np.testing.assert_array_equal(n.numpy(), ref_n)
    np.testing.assert_array_equal(out.numpy(), ref_out)
    assert {1, K + 1} <= set(ref_n.tolist()) and len(set(ref_n.tolist())) > 2
    assert (ref_n[24:32] == 1).all()


@pytest.mark.parametrize('K', [1, 3])
def test_output_distribution_matches_target(K):
    """Draft tokens drawn from the draft; the first emitted token must follow the
    target's distribution (chi-square over 24,000 rows, p > 1e-3)."""
    from lmdeploy_tpu_torch.ops.spec_sampling import draw, reject_sample
    from lmdeploy_tpu_torch.ops.sampling import hash_uniform
    N, V = 24000, 5
    target = torch.tensor([0.45, 0.25, 0.15, 0.1, 0.05])
    draft = torch.tensor([0.1, 0.2, 0.4, 0.2, 0.1])
    seeds = torch.arange(N, dtype=torch.int64) * 2654435761 % (1 << 32)
    toks = torch.stack([draw(draft.expand(N, V), hash_uniform(seeds + 17 * i, V, 99))
                        for i in range(K)], 1)
    out, n = reject_sample(target.expand(N, K + 1, V).contiguous(),
                           draft.expand(N, K, V).contiguous(), toks, seeds)
    counts = np.bincount(out[:, 0].numpy(), minlength=V)
    chi2, p = stats.chisquare(counts, target.numpy() * N)
    assert p > 1e-3, (counts, chi2, p)
    assert 1 <= int(n.min()) and int(n.max()) <= K + 1


def test_expected_acceptance_rate_matches_jax():
    from lmdeploy_tpu.ops.spec_sampling import expected_acceptance_rate as jrate
    from lmdeploy_tpu_torch.ops.spec_sampling import expected_acceptance_rate as trate
    rng = np.random.RandomState(2)
    t = _softmax(rng.randn(3, 5, 11))
    d = _softmax(rng.randn(3, 4, 11))
    np.testing.assert_allclose(trate(torch.from_numpy(t), torch.from_numpy(d)).numpy(),
                               np.asarray(jrate(jnp.asarray(t), jnp.asarray(d))),
                               rtol=1e-6, atol=1e-6)


def test_advance_rows_matches_a_plain_loop():
    """Each active row takes its last emitted token, grows position and step_no by its
    count and counts each emitted token once (repeats included); an inactive row and
    a row's feature follow the last emitted position."""
    from lmdeploy_tpu_torch.engine.spec_agent import advance_rows
    B, K, V, F = 6, 3, 10, 4
    rng = np.random.RandomState(9)
    out = rng.randint(0, V, (B, K + 1)).astype(np.int32)
    out[0] = [4, 4, 4, 4]
    n = np.array([4, 1, 2, 3, 0, 4], np.int32)
    act = np.array([1, 1, 1, 1, 0, 1], bool)
    row = {'active': torch.from_numpy(act), 'token': torch.arange(B, dtype=torch.int32),
           'position': torch.full((B,), 10, dtype=torch.int32),
           'step_no': torch.full((B,), 3, dtype=torch.int32)}
    counts = torch.zeros((B + 1, V), dtype=torch.int32)
    hidden = torch.zeros((B, F))
    feats = torch.from_numpy(rng.randn(B, K + 1, F).astype(np.float32))
    advance_rows(row, counts[:B], torch.from_numpy(out), torch.from_numpy(n), hidden, feats)
    ref_counts = np.zeros((B + 1, V), np.int32)
    for b in range(B):
        for j in range(n[b]):
            ref_counts[b, out[b, j]] += 1
        last = max(n[b] - 1, 0)
        assert row['token'][b] == (out[b, last] if act[b] else b)
        np.testing.assert_array_equal(hidden[b].numpy(),
                                      feats[b, last].numpy() if act[b] else np.zeros(F))
    np.testing.assert_array_equal(counts.numpy(), ref_counts)
    np.testing.assert_array_equal(row['position'].numpy(), 10 + n)
    np.testing.assert_array_equal(row['step_no'].numpy(), 3 + n)
