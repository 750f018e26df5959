"""gpt-oss with MXFP4-resident experts: the port against the JAX package (CPU).

The tiny checkpoint is tests/test_moe_quant.py's gpt-oss config (2 layers, window 32
on layer 0, 4 experts top-2, sinks, biases) with MXFP4 expert tensors written by
safetensors.  Checked: the gpt-oss-20b config and its yarn rope table, the loader's
leaves (bit-equal codes and scales, de-interleaved gate / up), ``GptOssModel.forward``
logits with weights from ``params_from_jax`` on prompts longer than the window, exact
greedy tokens of the port's ``Engine`` against the JAX ``Engine``, and the
dequantize-at-load switch against the MXFP4-resident run.

Tolerances: logits in f32 at 1e-4 absolute (logits here reach ~0.5).  Both sides round
the same x to bf16 before every expert product, but x itself differs by f32 summation
order, so an element that sits on a bf16 rounding boundary can round the other way on
one side: one bf16 ulp (2^-8 relative) of one input, ~1e-5 on an output.  The yarn
table: 2e-6 absolute at positions 0 and 1 (the scaled frequencies and the attention
factor); over 4096 positions 3.5e-4, since the two libraries' f32 frequencies may
differ by one ulp (2^-24 relative), which moves an angle at position 4095 by up to
2.4e-4 rad, times the yarn attention factor 1.35.
"""
import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import GPT_OSS_20B
from conftest import make_tiny_tokenizer
from test_moe_quant import GPTOSS_Q_CFG

ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=4,
                 session_len=256, max_prefill_token_num=64)
LOGIT_ATOL = 1e-4


def _write_checkpoint(path, seed=13):
    """The tiny gpt-oss checkpoint with MXFP4 expert tensors (random e2m1 codes and
    ue8m0 scales), as tests/test_moe_quant.py writes it."""
    from safetensors.numpy import save_file
    c = GPTOSS_Q_CFG
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(c, f)
    make_tiny_tokenizer(str(path), vocab_size=128)
    rng = np.random.RandomState(seed)
    H, V, E, Ie = c['hidden_size'], c['vocab_size'], c['num_local_experts'], \
        c['intermediate_size']
    nh, nkv, hd = c['num_attention_heads'], c['num_key_value_heads'], c['head_dim']
    t = {'model.embed_tokens.weight': rng.randn(V, H) * 0.02,
         'model.norm.weight': np.ones(H),
         'lm_head.weight': rng.randn(V, H) * 0.02}
    for layer in range(c['num_hidden_layers']):
        p = f'model.layers.{layer}.'
        t[p + 'input_layernorm.weight'] = np.ones(H)
        t[p + 'post_attention_layernorm.weight'] = np.ones(H)
        for hf, od in (('q_proj', nh * hd), ('k_proj', nkv * hd), ('v_proj', nkv * hd)):
            t[p + f'self_attn.{hf}.weight'] = rng.randn(od, H) * 0.05
            t[p + f'self_attn.{hf}.bias'] = rng.randn(od) * 0.02
        t[p + 'self_attn.o_proj.weight'] = rng.randn(H, nh * hd) * 0.05
        t[p + 'self_attn.o_proj.bias'] = rng.randn(H) * 0.02
        t[p + 'self_attn.sinks'] = rng.randn(nh) * 0.5
        t[p + 'mlp.router.weight'] = rng.randn(E, H) * 0.05
        t[p + 'mlp.router.bias'] = rng.randn(E) * 0.1
        t[p + 'mlp.experts.gate_up_proj_blocks'] = rng.randint(
            0, 256, size=(E, 2 * Ie, H // 32, 16)).astype(np.uint8)
        t[p + 'mlp.experts.gate_up_proj_scales'] = rng.randint(
            121, 125, size=(E, 2 * Ie, H // 32)).astype(np.uint8)
        t[p + 'mlp.experts.gate_up_proj_bias'] = rng.randn(E, 2 * Ie) * 0.1
        t[p + 'mlp.experts.down_proj_blocks'] = rng.randint(
            0, 256, size=(E, H, Ie // 32, 16)).astype(np.uint8)
        t[p + 'mlp.experts.down_proj_scales'] = rng.randint(
            121, 125, size=(E, H, Ie // 32)).astype(np.uint8)
        t[p + 'mlp.experts.down_proj_bias'] = rng.randn(E, H) * 0.1
    t = {k: np.ascontiguousarray(v if v.dtype == np.uint8 else v.astype(np.float32))
         for k, v in t.items()}
    save_file(t, os.path.join(path, 'model.safetensors'))
    return str(path)


@pytest.fixture(scope='module')
def mxfp4_dir(tmp_path_factory):
    return _write_checkpoint(tmp_path_factory.mktemp('tiny_gptoss_mxfp4'))


def _models(path, dtype='float32'):
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu.weight_loader import load_model_params
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models import build_model as tbuild
    from lmdeploy_tpu_torch.weight_loader import load_params
    jm = jbuild(JConfig.from_pretrained(path, dtype=dtype))
    tm = tbuild(TConfig.from_pretrained(path, dtype=dtype))
    jp = jax.tree_util.tree_map(np.asarray, load_model_params(jm, path))
    return jm, jp, tm, load_params(tm, path, 'cpu')


# -- config ------------------------------------------------------------------------------
def test_gpt_oss_20b_config_and_yarn_table():
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    from lmdeploy_tpu_torch.models.gpt_oss import GptOssModel
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    cfg = ModelConfig.from_hf_config(GPT_OSS_20B)
    assert (cfg.num_experts, cfg.num_experts_per_tok, cfg.num_layers) == (32, 4, 24)
    assert (cfg.hidden_size, cfg.intermediate_size, cfg.head_dim) == (2880, 2880, 64)
    assert not cfg.window_uniform and cfg.sliding_window == 128
    assert cfg.dtype == 'bfloat16' and cfg.vocab_size == 201088
    model = build_model(cfg)
    assert isinstance(model, GptOssModel) and cfg.attention_bias and model.moe_mxfp4
    assert model.layer_windows == [128, 0] * 12
    shapes = model.param_shapes()['layers']
    assert shapes['we_gate']['nib'].shape == (24, 32, 1440, 2880)
    assert shapes['we_down']['scale'].shape == (24, 32, 90, 2880)
    assert shapes['sinks'] == (24, 64)
    # the yarn table (factor 32 from 4096, truncate: false) equals the reference's
    got = trope(cfg.rope_dim, 4096, cfg.rope_theta, cfg.rope_scaling)
    want = jrope(cfg.rope_dim, 4096, cfg.rope_theta, cfg.rope_scaling)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[:2], np.asarray(w)[:2], rtol=0, atol=2e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=3.5e-4)


def test_seeded_init_and_fusion(monkeypatch):
    """Seeded MXFP4 leaves (u8 codes, power-of-two scales), the Python-int windows, and
    no gate / up fusion for an overridden ``_mlp`` (qkv still fuses)."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    cfg = ModelConfig.from_hf_config(GPTOSS_Q_CFG, dtype='float32')
    model = build_model(cfg)
    a, b = model.init_params(3), model.init_params(3)
    lay = a['layers']
    assert lay['we_up']['nib'].dtype == torch.uint8 and int(lay['we_up']['nib'].max()) > 15
    assert torch.equal(lay['we_up']['nib'], b['layers']['we_up']['nib'])
    exps = torch.log2(lay['we_down']['scale'])
    assert set(exps.unique().tolist()) == {-8.0, -7.0}
    assert model.layer_windows == [32, 0] and 'layer_window' not in lay
    fused = model.fuse_projections(a)['layers']
    assert 'wqkv' in fused and 'bqkv' in fused and 'w_gateup' not in fused
    monkeypatch.setenv('LMDEPLOY_TPU_MXFP4_DEQUANT', '1')
    dense = build_model(ModelConfig.from_hf_config(GPTOSS_Q_CFG, dtype='float32'))
    assert dense.param_shapes()['layers']['we_gate'] == (2, 4, 64, 64)


# -- loader and forward --------------------------------------------------------------------
@pytest.mark.parametrize('dequant', [False, True])
def test_loader_matches_jax(mxfp4_dir, monkeypatch, dequant):
    if dequant:
        monkeypatch.setenv('LMDEPLOY_TPU_MXFP4_DEQUANT', '1')
    _, jp, tm, tp = _models(mxfp4_dir)
    assert tm.moe_mxfp4 is not dequant
    for name, leaf in tp['layers'].items():
        ref = jp['layers'][name]
        if isinstance(leaf, dict):
            assert leaf['nib'].dtype == torch.uint8 and leaf['scale'].dtype == torch.float32
            for key in ('nib', 'scale'):
                np.testing.assert_array_equal(leaf[key].numpy(), ref[key])
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref, leaf.numpy().dtype))
    # the reference's window leaf is the port's Python-int schedule
    assert 'layer_window' not in tp['layers']
    assert np.asarray(jp['layers']['layer_window']).astype(int).tolist() == tm.layer_windows


def test_forward_logits_match_jax(mxfp4_dir):
    """Prefill of two rows longer than the window (one chunked: its second chunk reads
    the cache), then 4 decode steps; logits and the cache against the reference."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.weight_convert import (cache_from_reference,
                                                   cache_to_reference, params_from_jax)
    jm, jp, tm, _ = _models(mxfp4_dir)
    tp = tm.fuse_projections(params_from_jax(jp, dtype=torch.float32))
    assert np.asarray(jp['layers']['layer_window']).astype(int).tolist() == tm.layer_windows
    jp = jm.fuse_projections(jax.tree_util.tree_map(jnp.asarray, jp))
    cfg = jm.config
    L, BS, NB, Hkv, D = cfg.num_layers, 16, 12, cfg.num_key_value_heads, cfg.head_dim
    _, hdp = kv_row_width(Hkv, D)
    jcache = jnp.zeros((L, NB, 2, BS, hdp), jnp.float32)
    tcache = cache_from_reference(np.asarray(jcache), Hkv, D)
    jcos, jsin = jrope(D, 256, cfg.rope_theta)
    tcos, tsin = trope(D, 256, cfg.rope_theta)
    tables = np.array([[1, 2, 3, 4, 5], [6, 7, 8, 9, 10]], np.int32)
    ids = np.random.RandomState(0).randint(3, cfg.vocab_size, size=(2, 80)).astype(np.int32)
    steps = [((0, 0), (40, 48), 48, True), ((40, 48), (24, 0), 24, False)] + [
        ((64 + i, 48 + i), (1, 1), 1, False) for i in range(4)]
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
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(cache_to_reference(tcache)[:, 1:],
                                   np.asarray(jcache)[:, 1:], rtol=0, atol=LOGIT_ATOL)


# -- engine ------------------------------------------------------------------------------
def _greedy(pkg, path, prompts, new_tokens=12, **cfg):
    if pkg == 'jax':
        from lmdeploy_tpu.engine.engine import Engine
        from lmdeploy_tpu.messages import GenerationConfig, TpuEngineConfig
        kw = {}
    else:
        from lmdeploy_tpu_torch.engine.engine import Engine
        from lmdeploy_tpu_torch.messages import GenerationConfig, TpuEngineConfig
        kw = {'device': 'cpu'}
    engine = Engine.from_pretrained(path, TpuEngineConfig(**dict(ENGINE_KW, **cfg)), **kw)
    inst = engine.create_instance()
    gen = GenerationConfig(max_new_tokens=new_tokens, ignore_eos=True)

    async def go():
        return await asyncio.gather(*[inst.async_infer(i + 1, p, gen)
                                      for i, p in enumerate(prompts)])
    try:
        return [o.token_ids for o in asyncio.run(go())], engine
    finally:
        engine.close()


def _prompts():
    rng = np.random.RandomState(5)
    return [rng.randint(3, 128, size=n).tolist() for n in (45, 70)]


def test_engine_greedy_tokens_match_jax(mxfp4_dir):
    """Two concurrent prompts past the 32-token window (the 70-token one in two prefill
    chunks), 12 greedy tokens each, f32."""
    from lmdeploy_tpu_torch.ops import quant_bmm
    ref, _ = _greedy('jax', mxfp4_dir, _prompts())
    out, engine = _greedy('torch', mxfp4_dir, _prompts())
    assert out == ref
    assert all(len(t) == 12 for t in out)
    assert isinstance(engine.model_agent.params['layers']['we_gate'], dict)
    assert quant_bmm.mxfp4_bmm.launches == 0          # CPU tensors: the plain version


def test_engine_dequant_switch_matches_resident(mxfp4_dir, monkeypatch):
    """bf16, as the reference's own test: dequantizing the experts at load gives the
    MXFP4-resident run's greedy tokens, with about 3.2x the expert bytes."""
    got, eng = _greedy('torch', mxfp4_dir, _prompts(), dtype='bfloat16')
    lay = eng.model_agent.params['layers']
    quant_bytes = sum(t.numel() * t.element_size() for k in ('we_gate', 'we_up', 'we_down')
                      for t in lay[k].values())
    monkeypatch.setenv('LMDEPLOY_TPU_MXFP4_DEQUANT', '1')
    want, eng = _greedy('torch', mxfp4_dir, _prompts(), dtype='bfloat16')
    lay = eng.model_agent.params['layers']
    dense_bytes = sum(lay[k].numel() * lay[k].element_size()
                      for k in ('we_gate', 'we_up', 'we_down'))
    assert got == want
    # 0.5 B codes + 4 B / 32 scales = 0.625 B a weight against 2 (bf16)
    assert quant_bytes < 0.4 * dense_bytes


def test_pipeline_on_cpu_matches_jax(mxfp4_dir):
    from lmdeploy_tpu import pipeline as jpipeline
    from lmdeploy_tpu.messages import GenerationConfig as JGen
    from lmdeploy_tpu.messages import TpuEngineConfig as JCfg
    from lmdeploy_tpu_torch import pipeline as tpipeline
    from lmdeploy_tpu_torch.messages import GenerationConfig as TGen
    from lmdeploy_tpu_torch.messages import TpuEngineConfig as TCfg
    prompts = ['hello world this is a tiny test corpus ' * 2, 'hi']
    runs = []
    for make, cfg, gen, extra in ((jpipeline, JCfg, JGen, {}),
                                  (tpipeline, TCfg, TGen, {'device': 'cpu'})):
        pipe = make(mxfp4_dir, backend_config=cfg(**ENGINE_KW), **extra)
        try:
            runs.append(pipe(prompts, gen_config=gen(max_new_tokens=6, ignore_eos=True)))
        finally:
            pipe.close()
    ref, out = runs
    assert [o.token_ids for o in out] == [r.token_ids for r in ref]
    assert [o.text for o in out] == [r.text for r in ref]
