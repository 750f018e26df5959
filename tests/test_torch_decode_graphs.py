"""The port's compiled decode runs (engine/graph_runner.py, ModelAgent.decode_run /
warmup / eager_mode) against the JAX agent's jitted ones, on the CPU.

On the CPU nothing is captured: the agent keeps one entry per run key, as the JAX
agent keeps one executable, and calls the same body over the same static buffers.
These tests hold the keys, the warm-up enumeration, the tokens with and without
``eager_mode``, outputs that outlive the next run of the same key, the decode state's
fixed storage (a graph reads it by address) and the predicate that keeps a run eager.
"""
import asyncio
import gc

import numpy as np
import pytest
import torch

ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=8,
                 session_len=256, max_prefill_token_num=64)


def _pkg(pkg):
    if pkg == 'jax':
        from lmdeploy_tpu.engine.engine import Engine
        from lmdeploy_tpu.messages import GenerationConfig, TpuEngineConfig
        return Engine, GenerationConfig, TpuEngineConfig, {}
    from lmdeploy_tpu_torch.engine.engine import Engine
    from lmdeploy_tpu_torch.messages import GenerationConfig, TpuEngineConfig
    return Engine, GenerationConfig, TpuEngineConfig, {'device': 'cpu'}


def _prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 250, size=n).tolist() for n in lengths]


# two waves, one after the other: greedy requests of several lengths (one asks for top
# logprobs), then seeded-sampled ones; each wave's requests arrive together
WAVES = (
    [(p, dict(max_new_tokens=n, **kw)) for p, n, kw in zip(
        _prompts(0, (9, 30, 17)), (5, 20, 37), ({}, {'logprobs': 2}, {}))],
    [(p, dict(max_new_tokens=n, do_sample=True, top_k=20, temperature=0.8,
              random_seed=11 + i)) for i, (p, n) in enumerate(zip(_prompts(1, (12, 25)),
                                                                  (9, 24)))],
)


def serve_waves(pkg, path, waves=WAVES, **cfg):
    """Each wave's requests gathered at once, the waves in turn; returns (tokens by
    wave, engine)."""
    Engine, GenerationConfig, TpuEngineConfig, kw = _pkg(pkg)
    engine = Engine.from_pretrained(path, TpuEngineConfig(**dict(ENGINE_KW, **cfg)), **kw)
    inst = engine.create_instance()

    async def go():
        out, sid = [], 0
        for wave in waves:
            outs = await asyncio.gather(*[
                inst.async_infer(sid + i + 1, p, GenerationConfig(ignore_eos=True, **g))
                for i, (p, g) in enumerate(wave)])
            sid += len(wave)
            out.append([o.token_ids for o in outs])
        return out
    try:
        return asyncio.run(go()), engine
    finally:
        engine.close()


def test_run_keys_match_jax_agent(tiny_model_dir):
    """Under the same traffic the port's agent builds the run keys the JAX agent
    jits: ('run', k, B, simple, top_lp, kmax, full_vocab)."""
    ref, jeng = serve_waves('jax', tiny_model_dir)
    out, eng = serve_waves('torch', tiny_model_dir)
    assert out[0] == ref[0]          # greedy; a sampled first token is the prefill's
    # full-vocab draw, whose threefry the port does not reproduce (ops/sampling.py)
    jax_keys = {k[1:] for k in jeng.model_agent._step_fns
                if isinstance(k, tuple) and k and k[0] == 'run'}
    port_keys = set(eng.model_agent.run_keys())
    assert port_keys == jax_keys
    assert {k[3] for k in port_keys} == {0, 32}          # top logprobs on and off
    assert {k[2] for k in port_keys} == {True, False}    # greedy and sampled variants


def test_warmup_builds_the_reference_enumeration(tiny_model_dir):
    """``warmup`` builds the keys the JAX agent's ``warmup`` lowers: both sampling
    variants of every power-of-two k up to ``decode_run_steps``, per batch bucket
    (the JAX side records its keys instead of compiling them)."""
    from lmdeploy_tpu.engine.model_agent import ModelAgent as JaxAgent
    Engine, _, TpuEngineConfig, kw = _pkg('torch')
    eng = Engine.from_pretrained(tiny_model_dir, TpuEngineConfig(**ENGINE_KW), **kw)
    JEngine, _, JConfig, _ = _pkg('jax')
    jeng = JEngine.from_pretrained(tiny_model_dir, JConfig(**ENGINE_KW))
    seen = []

    class _Lowered:
        def lower(self, *args):
            return self

        def compile(self):
            return self

    def record(self, k, B, simple=False, top_lp=0, kmax=64, full_vocab=False):
        seen.append((k, B, simple, top_lp, kmax, full_vocab))
        return _Lowered()
    try:
        for sizes in (None, [3, 5]):
            eng.model_agent.graphs.clear()
            seen.clear()
            eng.model_agent.warmup(batch_sizes=sizes)
            orig = JaxAgent._get_run_fn
            JaxAgent._get_run_fn = record
            try:
                jeng.model_agent.warmup(batch_sizes=sizes)
            finally:
                JaxAgent._get_run_fn = orig
            assert set(eng.model_agent.run_keys()) == set(seen)
            assert len(seen) == 5 * 2 * (1 if sizes is None else 2)   # k 1..16
        # a prefill chunk bucket runs one eager step and leaves the state as it was
        before = eng.model_agent.token_counts.clone()
        eng.model_agent.warmup(batch_sizes=[2], decode_ks=[1], prefill_tokens=[20])
        assert torch.equal(eng.model_agent.token_counts, before)
    finally:
        eng.close()
        jeng.close()


@pytest.mark.parametrize('variant', ['greedy', 'sampled'])
def test_eager_mode_tokens_equal_graph_mode_and_jax(tiny_model_dir, variant):
    """``eager_mode`` True and False give the same tokens, greedy and seeded-sampled,
    and greedy ones equal to the JAX engine's (a sampled request's first token is the
    prefill's full-vocab draw, whose threefry the port does not reproduce)."""
    waves = [WAVES[0]] if variant == 'greedy' else [WAVES[1]]
    eager, e1 = serve_waves('torch', tiny_model_dir, waves, eager_mode=True)
    graphs, e2 = serve_waves('torch', tiny_model_dir, waves)
    assert e1.model_agent.eager_mode and not e2.model_agent.eager_mode
    assert eager == graphs
    if variant == 'greedy':
        ref, _ = serve_waves('jax', tiny_model_dir, waves)
        assert graphs == ref
    else:
        again, _ = serve_waves('torch', tiny_model_dir, waves)
        assert again == graphs and all(len(t) == g['max_new_tokens']
                                       for t, (_, g) in zip(graphs[0], waves[0]))


def _agent_with_row(tiny_model_dir, prompt, k):
    """An agent with one prefilled sequence in its decode state and capacity for k
    decode tokens."""
    from lmdeploy_tpu_torch.paging.seq import SamplingParams
    Engine, _, TpuEngineConfig, kw = _pkg('torch')
    eng = Engine.from_pretrained(tiny_model_dir, TpuEngineConfig(**ENGINE_KW), **kw)
    sched, agent = eng.scheduler, eng.model_agent
    sched.add_session(1)
    seq = sched.seq_manager.get_session(1).add_sequence(prompt,
                                                        SamplingParams(max_new_tokens=64))
    chunks = sched.schedule().prefill_chunks
    first = agent.prefill(chunks).tokens_np()
    sched.on_prefill_done(chunks[0], int(first[0]))
    agent.insert_decode_rows([seq])
    assert sched.extend_decode_capacity(seq, k)
    agent.update_tables([seq])
    return eng, agent


def test_outputs_outlive_the_next_run(tiny_model_dir):
    """Two runs of one key dispatched before the first is fetched each return their own
    tokens: together, the tokens of one run twice as long."""
    prompt = _prompts(5, (21,))[0]
    eng, agent = _agent_with_row(tiny_model_dir, prompt, 8)
    a = agent.decode_run(1, 4, True)
    b = agent.decode_run(1, 4, True)
    got = np.concatenate([a.tokens_np(), b.tokens_np()])
    eng.close()
    eng, agent = _agent_with_row(tiny_model_dir, prompt, 8)
    want = agent.decode_run(1, 8, True).tokens_np()
    eng.close()
    assert (got == want).all()
    assert not (got[:4] == got[4:]).all()


def test_decode_state_keeps_its_storage(tiny_model_dir):
    """A graph reads the decode state by address: inserting, deactivating and
    re-tabling rows write in place."""
    from lmdeploy_tpu_torch.engine.decode_state import DecodeState
    eng, agent = _agent_with_row(tiny_model_dir, _prompts(6, (40,))[0], 16)
    st = agent.decode_state
    names = DecodeState.ROW_FIELDS + ('token_counts', 'prompt_mask')
    ptrs = {n: getattr(st, n).data_ptr() for n in names}
    seq = next(iter(eng.scheduler.running))
    active = st.active.clone()
    agent.deactivate_rows([seq.batch_slot])
    assert not st.active[seq.batch_slot]
    agent.insert_decode_rows([seq])
    assert torch.equal(st.active, active)
    assert eng.scheduler.extend_decode_capacity(seq, 48)
    agent.update_tables([seq])
    agent.decode_run(1, 2, False)
    assert {n: getattr(st, n).data_ptr() for n in names} == ptrs
    assert st.tables[seq.batch_slot, :len(seq.logical_blocks)].tolist() == \
        list(seq.logical_blocks)
    eng.close()


def test_eager_predicate():
    """A decode run stays eager on the card only for cp ranks on several devices and
    for an MoE bucket that reaches the grouped expert GEMM (128 rows on dense and
    widened W4A16 stacks, 768 on MXFP4 and blocked-fp8 stacks)."""
    from lmdeploy_tpu_torch.engine.model_agent import eager_reason, ragged_min_rows
    from lmdeploy_tpu_torch.parallel.mesh import Mesh
    z = torch.zeros(1)
    dense = {'layers': {'we_gate': z}}
    w4 = {'layers': {'we_gate': {'packed': z, 'scales': z, 'zeros': z}}}
    mx = {'layers': {'we_gate': {'nib': z, 'scale': z}}}
    fp8 = {'layers': {'wq': z}, 'moe_layers': {'we_gate': {'w8': z, 'gscale': z}}}
    assert [ragged_min_rows(p) for p in (dense, w4, mx, fp8, {'layers': {'wq': z}})] == \
        [128, 128, 768, 768, None]
    one = Mesh(['cuda:0', 'cuda:0'], {'cp': 2}).cp_devices
    two = Mesh(['cuda:0', 'cuda:1'], {'cp': 2}).cp_devices
    for B in (1, 64, 127, 128, 256, 767, 768):
        assert eager_reason((), None, B) is None
        assert eager_reason(one, None, B) is None
        assert eager_reason(two, None, B) is not None
        assert (eager_reason((), 128, B) is not None) == (B >= 128)
        assert (eager_reason(one, 768, B) is not None) == (B >= 768)


def test_agent_predicate_wiring(tiny_model_dir):
    """The agent asks the predicate with the run's bucket: a llama has no experts, so
    every key may be captured."""
    Engine, _, TpuEngineConfig, kw = _pkg('torch')
    eng = Engine.from_pretrained(tiny_model_dir, TpuEngineConfig(**ENGINE_KW), **kw)
    try:
        graphs = eng.model_agent.graphs
        assert all(graphs.eager_reason((16, B, True, 0, 64, False)) is None
                   for B in eng.model_agent.batch_buckets)
        assert not graphs.capture                      # the CPU never captures
    finally:
        eng.close()


class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: capture and replay do nothing."""
    replays = 0

    def capture_begin(self, pool=None, capture_error_mode='global'):
        pass

    def capture_end(self):
        pass

    def replay(self):
        _FakeGraph.replays += 1


def test_capture_counts_launches_per_replay(monkeypatch):
    """The runner's bookkeeping around a capture (the CUDA calls faked): one warm step
    on the scratch state, then the capture; the wrappers' counters are put back as they
    were, the capture's launches are kept with the graph, and ``launch_totals`` adds
    them once per replay.  A body that fails inside the capture raises and leaves no
    graph."""
    from lmdeploy_tpu_torch.engine.graph_runner import DecodeGraphs
    from lmdeploy_tpu_torch.ops import paged_decode
    fn = paged_decode.paged_decode_attention
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _FakeGraph)
    monkeypatch.setattr(torch.cuda, 'graph_pool_handle', lambda: None)
    monkeypatch.setattr(torch.cuda, 'memory_reserved', lambda device=None: 0)
    monkeypatch.setattr(fn, 'launches', 5)
    monkeypatch.setattr(fn, 'combines', 1)
    calls = []

    def body(run, scratch=False):
        k = 1 if scratch else run.key[0]
        calls.append(('scratch' if scratch else 'state', k))
        fn.launches += 2 * k            # two layers a step, each split and combined
        fn.combines += 2 * k
        if run.key[1] == 3 and not scratch:
            raise RuntimeError('capture failed')

    graphs = DecodeGraphs(body, torch.device('cpu'), capture=True,
                          eager_reason=lambda key: 'moe' if key[1] == 8 else None)
    key = (4, 2, True, 0, 64, False)
    run = graphs.prepare(key)
    assert calls == [('scratch', 1), ('state', 4)]
    assert (fn.launches, fn.combines) == (5, 1)
    assert run.launches == {'paged_decode_attention': 8}
    assert run.combines == {'paged_decode_attention': 8}
    fn.launches, fn.combines = 0, 0
    graphs.reset_counts()
    for _ in range(3):
        assert graphs.run(key) is run
    launches, combines = graphs.launch_totals()
    assert launches['paged_decode_attention'] == 24 and combines['paged_decode_attention'] == 24
    assert graphs.stats()['replays'] == 3 and graphs.stats()['eager_runs'] == 0
    # the predicate keeps a key eager: its runs call the body on the real state
    calls.clear()
    graphs.run((2, 8, True, 0, 64, False))
    assert calls == [('state', 2)] and graphs.stats()['eager_runs'] == 1
    with pytest.raises(RuntimeError, match='capture failed'):
        graphs.run((1, 3, True, 0, 64, False))
    assert graphs.runs[(1, 3, True, 0, 64, False)].graph is None
    assert not graphs.capturing and gc.isenabled()     # the collector is back on
