"""The port's speculative decoding end to end against the JAX engine (CPU, f32).

Greedy tokens of a batch of concurrent prompts must equal the JAX speculative engine's
and the plain engines' for ``draft_model`` (the target as its own draft), ``eagle`` and
``eagle3`` heads, on a plain and an int8 target cache; with penalties (counts frozen
across a step's positions, so not the plain tokens) and under preemption they must equal
the JAX speculative engine's.  Also: ``max_new_tokens`` when one step emits several, a
``logprobs`` row on the host-driven path, seeded sampling that repeats, the refusal of
Qwen3.5's MTP and of speculation under context parallelism, ``pipeline()`` with a speculative config, and the step's graph key.
"""
import numpy as np
import pytest
import torch

import spec_cases as sc

K = 3
NEW = 10


@pytest.fixture(scope='module')
def heads(tmp_path_factory):
    root = tmp_path_factory.mktemp('spec_heads')
    return {'eagle': sc.write_eagle(root / 'eagle'), 'eagle3': sc.write_eagle3(root / 'eagle3')}


def _spec(method, tiny_model_dir, heads, k=K):
    path = tiny_model_dir if method == 'draft_model' else heads[method]
    return dict(method=method, model=path, num_speculative_tokens=k)


PROMPTS = sc.make_prompts(5, (6, 14, 9, 30))


@pytest.fixture(scope='module')
def plain(tiny_model_dir):
    """The JAX engine's greedy tokens without speculation, per cache policy."""
    return {pol: sc.tokens('jax', tiny_model_dir, PROMPTS, NEW, quant_policy=pol)
            for pol in (0, 4)}


@pytest.mark.parametrize('policy', [0, 4])
@pytest.mark.parametrize('method', ['draft_model', 'eagle', 'eagle3'])
def test_greedy_tokens_match_jax(tiny_model_dir, heads, plain, method, policy):
    spec = _spec(method, tiny_model_dir, heads)
    ref, ref_emitted = sc.spec_run('jax', tiny_model_dir, PROMPTS, NEW, spec,
                                   quant_policy=policy)
    engine = sc.build('torch', tiny_model_dir, spec, quant_policy=policy)
    emitted = []
    step = engine.spec.spec_decode
    engine.spec.spec_decode = lambda n: emitted.append(step(n)) or emitted[-1]
    try:
        got = [o.token_ids for o in sc.serve(engine, PROMPTS, NEW)]
        agent = engine.model_agent
        assert engine.spec.method == method and agent.spec is engine.spec
        assert engine.spec.draft_kv.shape[0] == (1 if method != 'draft_model' else 2)
        assert engine.spec.draft_kv.dtype == torch.float32     # never the int8 cache's
        # every decode round was a speculative step, counted under its (method, B) key
        runs = agent.graphs.runs
        assert runs and all(key[:2] == ('spec', method) for key in runs)
        assert sum(r.eager_runs for r in runs.values()) == len(emitted)
    finally:
        engine.close()
    assert got == ref == plain[policy]
    # the proposers agree with the reference's: the same emitted counts, step by step
    assert [e[1].tolist() for e in emitted] == ref_emitted


@pytest.mark.parametrize('case', ['penalties', 'preempt'])
def test_draft_model_cases_match_jax(tiny_model_dir, heads, case):
    kw, gen = {}, None
    if case == 'penalties':
        gen = dict(repetition_penalty=1.3, frequency_penalty=0.2, presence_penalty=0.1)
    else:
        kw = dict(num_gpu_blocks=9)          # 8 usable blocks of 16 tokens for 4 rows
    spec = _spec('draft_model', tiny_model_dir, heads)
    ref = sc.tokens('jax', tiny_model_dir, PROMPTS, 2 * NEW, spec=spec, gen_kw=gen, **kw)
    engine = sc.build('torch', tiny_model_dir, spec, **kw)
    try:
        got = [o.token_ids for o in sc.serve(engine, PROMPTS, 2 * NEW, gen)]
        if case == 'preempt':
            assert engine.scheduler.num_preemptions > 0
    finally:
        engine.close()
    assert got == ref


def test_max_new_tokens_with_several_tokens_a_step(tiny_model_dir, heads):
    """7 and 2 new tokens at K = 4 (a self-draft emits 5 a step): each request stops
    at its budget."""
    engine = sc.build('torch', tiny_model_dir, _spec('draft_model', tiny_model_dir, heads, 4))
    try:
        outs = [sc.serve(engine, [p], n, first_session=10 + i)[0]
                for i, (p, n) in enumerate(((PROMPTS[0], 7), (PROMPTS[1], 2)))]
    finally:
        engine.close()
    assert [len(o.token_ids) for o in outs] == [7, 2]


def test_logprobs_row_takes_host_path(tiny_model_dir, heads):
    """A row asking for top logprobs decodes one host step at a time, out of the device
    state; its tokens and top logprobs equal the plain engine's, the others'
    tokens too."""
    gen = [None, dict(logprobs=3), None]
    plain = sc.build('torch', tiny_model_dir)
    try:
        ref = sc.serve(plain, PROMPTS[:3], NEW, gen)
    finally:
        plain.close()
    engine = sc.build('torch', tiny_model_dir, _spec('eagle', tiny_model_dir, heads))
    agent = engine.model_agent
    host_rows = []
    decode = agent.decode

    def counted(seqs):
        host_rows.extend(s.seq_id for s in seqs)
        return decode(seqs)
    agent.decode = counted
    try:
        outs = sc.serve(engine, PROMPTS[:3], NEW, gen)
    finally:
        engine.close()
    assert [o.token_ids for o in outs] == [o.token_ids for o in ref]
    assert len(host_rows) == NEW - 1 and len(set(host_rows)) == 1
    for got, want in zip(outs[1].logprobs, ref[1].logprobs):
        assert list(got) == list(want)
        np.testing.assert_allclose([got[t].logprob for t in got],
                                   [want[t].logprob for t in want], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('method', ['draft_model', 'eagle3'])
def test_seeded_sampling_repeats(tiny_model_dir, heads, method):
    """The same seeds on fresh engines give the same sampled tokens (greedy rows beside
    them keep the plain tokens)."""
    gen = [dict(do_sample=True, temperature=0.7, top_k=20, random_seed=1234), None,
           dict(do_sample=True, top_p=0.9, random_seed=99), None]
    spec = _spec(method, tiny_model_dir, heads)
    runs = [sc.tokens('torch', tiny_model_dir, PROMPTS, NEW, spec=spec, gen_kw=gen)
            for _ in range(2)]
    assert runs[0] == runs[1]
    assert all(len(t) == NEW for t in runs[0])
    greedy = sc.tokens('torch', tiny_model_dir, PROMPTS, NEW)
    assert [runs[0][i] for i in (1, 3)] == [greedy[i] for i in (1, 3)]


@pytest.mark.parametrize('method, item, cfg', [('deepseek_mtp', 'item 16', {'cp': 2}),
                                               ('qwen3_5_mtp', 'item 14', {})])
def test_mtp_methods_raise(tiny_model_dir, method, item, cfg):
    """Qwen3.5's MTP is not ported, and no method runs under context parallelism."""
    with pytest.raises(NotImplementedError, match=item):
        sc.build('torch', tiny_model_dir, dict(method=method, num_speculative_tokens=2),
                 **cfg)


def test_pipeline_with_speculative_config(tiny_model_dir, heads):
    from lmdeploy_tpu_torch import GenerationConfig, SpeculativeConfig, pipeline
    from lmdeploy_tpu_torch.messages import TpuEngineConfig
    cfg = TpuEngineConfig(**sc.ENGINE_KW)
    gen = GenerationConfig(max_new_tokens=8, ignore_eos=True)
    prompts = ['hello world', 'this is a tiny test']
    outs = {}
    for name, spec in (('plain', None), ('eagle3', SpeculativeConfig(
            method='eagle3', model=heads['eagle3'], num_speculative_tokens=2))):
        pipe = pipeline(tiny_model_dir, backend_config=cfg, device='cpu',
                        speculative_config=spec)
        try:
            outs[name] = [r.token_ids for r in pipe(prompts, gen_config=gen)]
            assert (pipe.engine.engine.spec is None) == (spec is None)
        finally:
            pipe.close()
    assert outs['eagle3'] == outs['plain']


def test_step_rows_for_eager_reason(tiny_model_dir, heads):
    """The graph key of a step, and the rows its verify passes to ``eager_reason``:
    B * (K + 1), so an MoE target's expert route is judged at the verify's rows."""
    from lmdeploy_tpu_torch.engine.model_agent import eager_reason
    engine = sc.build('torch', tiny_model_dir, _spec('eagle', tiny_model_dir, heads))
    try:
        agent = engine.model_agent
        agent.warmup(batch_sizes=[4])
        assert list(agent.graphs.runs) == [('spec', 'eagle', 4)]
        rows = agent._graph_rows(('spec', 'eagle', 32))
        assert rows == 32 * (K + 1)
        assert eager_reason((), 128, rows) is not None and eager_reason((), 129, rows) is None
        agent.graphs.clear()
        assert not agent.graphs.runs
    finally:
        engine.close()
