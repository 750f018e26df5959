"""Mixtral / Qwen2-MoE / Qwen3-MoE (``MixtralModel``): the port against the JAX package
(CPU).

The tiny Mixtral is tests/test_moe.py's (4 experts, top-2, 2 layers); beside it a tiny
Qwen2-MoE (attention bias, ``norm_topk_prob`` false, a shared expert that both
packages drop) and a tiny Qwen3-MoE (qk-norm), both in the qwen-moe naming.  Checked:
the loaders' trees (bit-equal, through ``params_from_jax`` too), ``forward`` logits in
f32, exact greedy tokens of ``Engine`` and ``pipeline()``, the W4A16 MoE checkpoint the
JAX ``auto_awq`` writes served by both packages under each W4A16 schedule, and the
gates of ``prep_quant_leaves`` (4-D expert stacks and classes that override
``forward`` stay raw).

Tolerances: logits in f32 at 1e-5 absolute (logits here reach ~0.1; both sides
multiply the same f32 values, summing in another order).  W4A16 tokens: on the CPU the
JAX package runs its dense routes (each attention weight rounded to bf16 once), while
the port runs the schedule's kernel plain version at decode (gd and unprepared: no
per-weight rounding; fast and precise: the kernel's own rounding of each product with
its bf16 scale), so logits differ by ~1e-3 and tokens are compared under
tests/test_torch_quant_matmul.py's top-2 margin rule.
"""
import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_tiny_tokenizer
from test_moe import MOE_CFG, moe_model_dir  # noqa: F401  (the tiny Mixtral fixture)
from test_torch_quant_matmul import LOGIT_ATOL, _margin_rule

ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=4,
                 session_len=256, max_prefill_token_num=64)
LOGITS_ATOL = 1e-5
SCHEDULES = {'gd': {}, 'fast': {'LMDEPLOY_TPU_W4_FAST': '1'},
             'precise': {'LMDEPLOY_TPU_W4_SCHED': 'precise'},
             'unprepared': {'LMDEPLOY_TPU_W4_STACKED': '0'}}

QWEN_MOE = {
    'Qwen2MoeForCausalLM': dict(model_type='qwen2_moe', norm_topk_prob=False,
                                shared_expert_intermediate_size=96),
    'Qwen3MoeForCausalLM': dict(model_type='qwen3_moe', norm_topk_prob=True),
}


def _write_qwen_moe(path, arch: str, seed: int = 3) -> str:
    """A tiny Qwen2-MoE or Qwen3-MoE checkpoint in the qwen-moe naming."""
    from safetensors.numpy import save_file
    H, I, Ie, V, E, nh, nkv, hd = 64, 96, 48, 128, 4, 4, 2, 16
    cfg = dict(MOE_CFG, architectures=[arch], intermediate_size=I, moe_intermediate_size=Ie,
               num_experts=E, **QWEN_MOE[arch])
    cfg.pop('num_local_experts')
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(cfg, f)
    make_tiny_tokenizer(str(path), vocab_size=V)
    rng = np.random.RandomState(seed)
    t = {'model.embed_tokens.weight': rng.randn(V, H) * 0.02,
         'model.norm.weight': np.ones(H), 'lm_head.weight': rng.randn(V, H) * 0.02}
    for layer in range(2):
        p = f'model.layers.{layer}.'
        t[p + 'input_layernorm.weight'] = 1 + rng.randn(H) * 0.1
        t[p + 'post_attention_layernorm.weight'] = 1 + rng.randn(H) * 0.1
        for hf, od in (('q_proj', nh * hd), ('k_proj', nkv * hd), ('v_proj', nkv * hd)):
            t[p + f'self_attn.{hf}.weight'] = rng.randn(od, H) * 0.05
            if arch == 'Qwen2MoeForCausalLM':
                t[p + f'self_attn.{hf}.bias'] = rng.randn(od) * 0.02
        t[p + 'self_attn.o_proj.weight'] = rng.randn(H, nh * hd) * 0.05
        if arch == 'Qwen3MoeForCausalLM':
            t[p + 'self_attn.q_norm.weight'] = 1 + rng.randn(hd) * 0.1
            t[p + 'self_attn.k_norm.weight'] = 1 + rng.randn(hd) * 0.1
        t[p + 'mlp.gate.weight'] = rng.randn(E, H) * 0.5
        for e in range(E):
            q = p + f'mlp.experts.{e}.'
            t[q + 'gate_proj.weight'] = rng.randn(Ie, H) * 0.05
            t[q + 'up_proj.weight'] = rng.randn(Ie, H) * 0.05
            t[q + 'down_proj.weight'] = rng.randn(H, Ie) * 0.05
        if arch == 'Qwen2MoeForCausalLM':        # loaded by neither package
            for hf, shape in (('gate_proj', (I, H)), ('up_proj', (I, H)),
                              ('down_proj', (H, I))):
                t[p + f'mlp.shared_expert.{hf}.weight'] = rng.randn(*shape) * 0.05
            t[p + 'mlp.shared_expert_gate.weight'] = rng.randn(1, H) * 0.05
    save_file({k: np.ascontiguousarray(v.astype(np.float32)) for k, v in t.items()},
              os.path.join(path, 'model.safetensors'))
    return str(path)


@pytest.fixture(scope='module')
def moe_dirs(moe_model_dir, tmp_path_factory):  # noqa: F811
    dirs = {'MixtralForCausalLM': moe_model_dir}
    for arch in QWEN_MOE:
        dirs[arch] = _write_qwen_moe(tmp_path_factory.mktemp(arch), arch)
    return dirs


def _models(path):
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu.weight_loader import load_model_params
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models import build_model as tbuild
    from lmdeploy_tpu_torch.weight_loader import load_params
    jm = jbuild(JConfig.from_pretrained(path, dtype='float32'))
    tm = tbuild(TConfig.from_pretrained(path, dtype='float32'))
    return jm, load_model_params(jm, path), tm, load_params(tm, path, 'cpu')


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _assert_trees_equal(tp, ref):
    assert set(tp) == set(ref), (sorted(tp), sorted(ref))
    for k, v in tp.items():
        if isinstance(v, dict):
            _assert_trees_equal(v, ref[k])
        else:
            assert v.dtype == ref[k].dtype, k
            assert torch.equal(v, ref[k]), k


# -- config, loader, logits -------------------------------------------------------------
@pytest.mark.parametrize('arch', ['MixtralForCausalLM', 'Qwen2MoeForCausalLM',
                                  'Qwen3MoeForCausalLM'])
def test_loader_matches_jax(moe_dirs, arch):
    """The registry's flags and the loaded tree (router, expert slices, qk-norm,
    biases) bit-equal to the JAX loader's through ``params_from_jax``."""
    from lmdeploy_tpu_torch.models.mixtral import MixtralModel
    from lmdeploy_tpu_torch.weight_convert import params_from_jax
    jm, jp, tm, tp = _models(moe_dirs[arch])
    assert isinstance(tm, MixtralModel)
    for flag in ('attention_bias', 'qk_norm', 'norm_topk_prob', 'num_experts',
                 'num_experts_per_tok', 'moe_intermediate_size'):
        assert getattr(tm.config, flag) == getattr(jm.config, flag), flag
    assert tm.config.norm_topk_prob == (arch != 'Qwen2MoeForCausalLM')
    _assert_trees_equal(tp, params_from_jax(_np_tree(jp)))
    lay = tp['layers']
    assert lay['we_gate'].shape[:2] == (2, 4) and lay['router'].shape == (2, 64, 4)
    assert not torch.equal(lay['we_gate'][0, 0], lay['we_gate'][0, 3])
    assert not any('shared' in k for k in lay)


@pytest.mark.parametrize('arch', ['MixtralForCausalLM', 'Qwen2MoeForCausalLM',
                                  'Qwen3MoeForCausalLM'])
def test_forward_logits_match_jax(moe_dirs, arch):
    """An 80-token and a 96-token prefill (the 96-token row in two chunks), then 3
    decode steps: f32 logits against the JAX ``MixtralModel``.  The first step's 160
    rows take the grouped-GEMM route (>= 128 rows), the later steps the dense
    combine."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference, params_from_jax
    jm, jp, tm, _ = _models(moe_dirs[arch])
    tp = tm.fuse_projections(params_from_jax(_np_tree(jp)))
    jp = jm.fuse_projections(jax.tree_util.tree_map(jnp.asarray, jp))
    cfg = jm.config
    L, BS, NB, Hkv, D = cfg.num_layers, 16, 16, cfg.num_key_value_heads, cfg.head_dim
    _, hdp = kv_row_width(Hkv, D)
    jcache = jnp.zeros((L, NB, 2, BS, hdp), jnp.float32)
    tcache = cache_from_reference(np.asarray(jcache), Hkv, D)
    jcos, jsin = jrope(D, 256, cfg.rope_theta)
    tcos, tsin = trope(D, 256, cfg.rope_theta)
    tables = np.array([[1, 2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13, 14]], np.int32)
    ids = np.random.RandomState(0).randint(3, cfg.vocab_size, size=(2, 104)).astype(np.int32)
    steps = [((0, 0), (80, 72), 80, True), ((80, 72), (0, 24), 24, False)] + [
        ((80 + i, 96 + i), (1, 1), 1, False) for i in range(3)]
    for hist, qlen, T, fresh in steps:
        hist, qlen = np.array(hist, np.int32), np.array(qlen, np.int32)
        x = np.zeros((2, T), np.int32)
        pos = np.zeros((2, T), np.int32)
        for b in range(2):
            x[b, :qlen[b]] = ids[b, hist[b]:hist[b] + qlen[b]]
            pos[b, :qlen[b]] = np.arange(hist[b], hist[b] + qlen[b])
        jl, jcache = jm.forward(jp, jnp.asarray(x), jnp.asarray(pos), jcache,
                                JMeta(jnp.asarray(tables), jnp.asarray(hist),
                                      jnp.asarray(qlen)), jcos, jsin, fresh_prefill=fresh)
        tl = tm.forward(tp, torch.from_numpy(x), torch.from_numpy(pos), tcache,
                        TMeta(torch.from_numpy(tables), torch.from_numpy(hist),
                              torch.from_numpy(qlen)), tcos, tsin, fresh_prefill=fresh)
        valid = qlen > 0
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], rtol=0,
                                   atol=LOGITS_ATOL)


# -- engine and pipeline ----------------------------------------------------------------
def _greedy(pkg, path, prompts, new_tokens=8):
    if pkg == 'jax':
        from lmdeploy_tpu.engine.engine import Engine
        from lmdeploy_tpu.messages import GenerationConfig, TpuEngineConfig
        kw = {}
    else:
        from lmdeploy_tpu_torch.engine.engine import Engine
        from lmdeploy_tpu_torch.messages import GenerationConfig, TpuEngineConfig
        kw = {'device': 'cpu'}
    engine = Engine.from_pretrained(path, TpuEngineConfig(**ENGINE_KW), **kw)
    inst = engine.create_instance()
    gen = GenerationConfig(max_new_tokens=new_tokens, ignore_eos=True)

    async def go():
        return await asyncio.gather(*[inst.async_infer(i + 1, p, gen)
                                      for i, p in enumerate(prompts)])
    try:
        return [o.token_ids for o in asyncio.run(go())]
    finally:
        engine.close()


@pytest.mark.parametrize('arch', ['Qwen2MoeForCausalLM', 'Qwen3MoeForCausalLM'])
def test_engine_greedy_tokens_match_jax(moe_dirs, arch):
    """Three concurrent prompts (one of 70 tokens, in two prefill chunks), 8 greedy
    tokens each, f32: exactly the JAX engine's."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(3, 128, size=n).tolist() for n in (12, 70, 30)]
    ref = _greedy('jax', moe_dirs[arch], prompts)
    assert _greedy('torch', moe_dirs[arch], prompts) == ref


def _pipeline_runs(path, prompts, new_tokens, env=None, monkeypatch=None, **gen_kw):
    from lmdeploy_tpu import pipeline as jpipeline
    from lmdeploy_tpu.messages import GenerationConfig as JGen
    from lmdeploy_tpu.messages import TpuEngineConfig as JCfg
    from lmdeploy_tpu_torch import pipeline as tpipeline
    from lmdeploy_tpu_torch.messages import GenerationConfig as TGen
    from lmdeploy_tpu_torch.messages import TpuEngineConfig as TCfg
    for k, v in (env or {}).items():
        monkeypatch.setenv(k, v)
    runs = []
    for make, cfg, gen, extra in ((jpipeline, JCfg, JGen, {}),
                                  (tpipeline, TCfg, TGen, {'device': 'cpu'})):
        pipe = make(path, backend_config=cfg(**ENGINE_KW), **extra)
        try:
            runs.append(pipe(prompts, gen_config=gen(max_new_tokens=new_tokens,
                                                     ignore_eos=True, **gen_kw)))
            if extra:
                runs.append(pipe.engine.engine.model_agent.params)
        finally:
            pipe.close()
    return runs


def test_pipeline_on_cpu_matches_jax(moe_dirs):
    ref, out, _ = _pipeline_runs(moe_dirs['MixtralForCausalLM'],
                                 ['hello world this is a tiny test', 'hi'], 6)
    assert [o.token_ids for o in out] == [r.token_ids for r in ref]
    assert [o.text for o in out] == [r.text for r in ref]


# -- W4A16 experts ----------------------------------------------------------------------
@pytest.fixture(scope='module')
def moe_awq_dir(moe_model_dir, tmp_path_factory):  # noqa: F811
    """The tiny Mixtral quantized by the JAX package's ``auto_awq`` (group 32), as
    tests/test_moe.py serves it."""
    from lmdeploy_tpu.lite.auto_awq import auto_awq
    work = str(tmp_path_factory.mktemp('moe_awq_torch'))
    auto_awq(moe_model_dir, work_dir=work, w_group_size=32, calib_samples=4,
             calib_seqlen=96)
    return work


@pytest.mark.parametrize('schedule', list(SCHEDULES))
def test_awq_moe_served_under_each_schedule(moe_awq_dir, monkeypatch, schedule):
    """Both packages serve the AWQ MoE checkpoint under the schedule's switches: the
    attention projections' leaf form follows the schedule, the expert stacks stay
    packed and raw, and the greedy tokens agree under the margin rule."""
    prompts = ['hello world this is a tiny test', 'hi there']
    ref, out, params = _pipeline_runs(moe_awq_dir, prompts, 6, SCHEDULES[schedule],
                                      monkeypatch, logprobs=2)
    lay = params['layers']
    want = {'gd': {'packed', 'sb', 'corr'}, 'fast': {'packed', 'sb', 'corr'},
            'precise': {'packed', 'sb', 'corr'}, 'unprepared': {'packed', 'scales', 'zeros'}}
    assert set(lay['wqkv']) == want[schedule]
    if schedule != 'unprepared':
        from lmdeploy_tpu_torch.ops.quant_matmul import schedule_of
        assert schedule_of(lay['wqkv']['sb'], lay['wqkv']['corr']) == schedule
    for name in ('we_gate', 'we_up', 'we_down'):
        assert set(lay[name]) == {'packed', 'scales', 'zeros'}
        assert lay[name]['packed'].dim() == 4
    agreed = [_margin_rule(r.token_ids, r.logprobs, o.token_ids) for r, o in zip(ref, out)]
    assert all(len(o.token_ids) == 6 for o in out) and sum(agreed) >= 6, agreed
    assert LOGIT_ATOL == 3e-3


# -- the gates of prep_quant_leaves -----------------------------------------------------
def test_prep_quant_leaves_gates():
    """Only 3-D ``[L, G, N]`` W4A16 leaves of a class running the stock ``forward``
    convert: a MoE model's 4-D expert stacks stay raw (its ``_mlp`` widens them with
    their raw scales and zeros), and a class that overrides ``forward`` keeps every
    leaf, as the reference's ``prep_quant_leaves`` (llama.py:449-456) does."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    from lmdeploy_tpu_torch.models.llama import LlamaModel
    cfg = ModelConfig.from_hf_config(dict(MOE_CFG, quantization_config={
        'quant_method': 'awq', 'group_size': 32}))
    model = build_model(cfg)
    params = model.fuse_projections(model.init_params(0))
    prepped = model.prep_quant_leaves(params, mode='precise')['layers']
    assert set(prepped['wqkv']) == {'packed', 'sb', 'corr'}
    assert prepped['wqkv']['corr'].dtype == torch.bfloat16
    for name in ('we_gate', 'we_up', 'we_down'):
        assert prepped[name] is params['layers'][name]

    class OwnForward(LlamaModel):
        def forward(self, *args, **kwargs):
            return super().forward(*args, **kwargs)
    dense = dict(MOE_CFG, architectures=['LlamaForCausalLM'],
                 quantization_config={'quant_method': 'awq', 'group_size': 32})
    own = OwnForward(ModelConfig.from_hf_config(dense))
    raw = own.init_params(0)
    assert own.prep_quant_leaves(raw) is raw and own.fuse_projections(raw) is raw
