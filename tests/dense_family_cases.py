"""Tiny checkpoints of the dense llama variants, and the checks the dense-family test
files share: the port against the JAX package on the CPU, in f32.

Each family's checkpoint is written here with safetensors under its own HF names
(fused ``qkv_proj`` / ``gate_up_proj`` / ``W_pack`` / ``query_key_value`` / grouped
``wqkv``, Gemma's ``w - 1`` norms, StarCoder2's LayerNorm biases and ``c_fc`` /
``c_proj``): 2-3 layers, width 64, random norms and biases, and windows (24 tokens)
shorter than the prompts.  The checks: the loaded trees against ``load_params_np``
(bit for bit), f32 logits of a chunked prefill and decode steps against the JAX
model's at ``ATOL``, and exact greedy tokens of ``Engine`` against the JAX engine.
"""
import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conftest import make_tiny_tokenizer

V = 128
H, NH, NKV, D, I = 64, 4, 2, 16, 96
WINDOW = 24
BASE = {'hidden_size': H, 'num_attention_heads': NH, 'num_key_value_heads': NKV,
        'head_dim': D, 'intermediate_size': I, 'vocab_size': V,
        'max_position_embeddings': 512, 'rope_theta': 10000.0, 'bos_token_id': 1,
        'eos_token_id': 2, 'torch_dtype': 'float32', 'rms_norm_eps': 1e-6,
        'num_hidden_layers': 2, 'tie_word_embeddings': False}
CFGS = {
    'gemma': dict(BASE, architectures=['GemmaForCausalLM'], model_type='gemma'),
    'gemma2': dict(BASE, architectures=['Gemma2ForCausalLM'], model_type='gemma2',
                   num_hidden_layers=3, sliding_window=WINDOW, query_pre_attn_scalar=24,
                   attn_logit_softcapping=2.0, final_logit_softcapping=3.0),
    'gemma3': dict(BASE, architectures=['Gemma3ForCausalLM'], model_type='gemma3_text',
                   num_hidden_layers=3, sliding_window=WINDOW, query_pre_attn_scalar=20,
                   layer_types=['sliding_attention', 'sliding_attention', 'full_attention'],
                   rope_theta=1000000.0, rope_local_base_freq=10000.0,
                   rope_scaling={'rope_type': 'linear', 'factor': 2.0}),
    'phi3': dict(BASE, architectures=['Phi3ForCausalLM'], model_type='phi3'),
    'glm4': dict(BASE, architectures=['Glm4ForCausalLM'], model_type='glm4',
                 partial_rotary_factor=0.5, attention_bias=True, rms_norm_eps=1e-5),
    'glm': dict(BASE, architectures=['GlmForCausalLM'], model_type='glm',
                partial_rotary_factor=0.5, attention_bias=True, rms_norm_eps=1e-5),
    'chatglm': {'architectures': ['ChatGLMModel'], 'model_type': 'chatglm',
                'num_layers': 2, 'hidden_size': H, 'num_attention_heads': NH,
                'multi_query_attention': True, 'multi_query_group_num': NKV,
                'kv_channels': D, 'ffn_hidden_size': I, 'padded_vocab_size': V,
                'layernorm_epsilon': 1e-5, 'seq_length': 512, 'add_qkv_bias': True,
                'rope_ratio': 2.0, 'bos_token_id': 1, 'eos_token_id': 2,
                'torch_dtype': 'float32'},
    'internlm2': dict(BASE, architectures=['InternLM2ForCausalLM'], model_type='internlm2'),
    'baichuan': dict(BASE, architectures=['BaichuanForCausalLM'], model_type='baichuan',
                     num_key_value_heads=NH),
    'internlm': dict(BASE, architectures=['InternLMForCausalLM'], model_type='internlm',
                     num_key_value_heads=NH),
    'starcoder2': {k: v for k, v in dict(
        BASE, architectures=['Starcoder2ForCausalLM'], model_type='starcoder2',
        sliding_window=WINDOW, norm_epsilon=1e-5, use_bias=True).items()
        if k not in ('rms_norm_eps', 'tie_word_embeddings')},
    'minicpm': dict(BASE, architectures=['MiniCPMForCausalLM'], model_type='minicpm',
                    scale_emb=12.0, scale_depth=1.4, dim_model_base=32,
                    tie_word_embeddings=True),
}
# the families whose prompts run past a window
WINDOWED = ('gemma2', 'gemma3', 'starcoder2')
ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=4,
                 session_len=256, max_prefill_token_num=64)
ATOL = 1e-4


def _tensors(name: str, rng) -> dict:
    """HF-named f32 tensors of the family ``name``."""
    c = CFGS[name]
    L = c.get('num_hidden_layers') or c['num_layers']
    nkv = c.get('num_key_value_heads') or c.get('multi_query_group_num') or NH
    qo, ko = NH * D, nkv * D
    gemma = name.startswith('gemma')
    t = {}

    def norm(key, n=H, bias=False):
        # Gemma stores w - 1: random around 0, so that 1 + w is around 1
        t[key + '.weight'] = (0.0 if gemma else 1.0) + 0.1 * rng.randn(n)
        if bias:
            t[key + '.bias'] = 0.1 * rng.randn(n)

    def lin(key, out_dim, in_dim, bias=False):
        t[key + '.weight'] = rng.randn(out_dim, in_dim) * 0.05
        if bias:
            t[key + '.bias'] = rng.randn(out_dim) * 0.05
    if name == 'chatglm':
        t['transformer.embedding.word_embeddings.weight'] = rng.randn(V, H) * 0.02
        t['transformer.output_layer.weight'] = rng.randn(V, H) * 0.02
        norm('transformer.encoder.final_layernorm')
        for layer in range(L):
            p = f'transformer.encoder.layers.{layer}.'
            norm(p + 'input_layernorm')
            norm(p + 'post_attention_layernorm')
            lin(p + 'self_attention.query_key_value', qo + 2 * ko, H, bias=True)
            lin(p + 'self_attention.dense', H, qo)
            lin(p + 'mlp.dense_h_to_4h', 2 * I, H)
            lin(p + 'mlp.dense_4h_to_h', H, I)
        return t
    emb = 'model.tok_embeddings.weight' if name == 'internlm2' else 'model.embed_tokens.weight'
    t[emb] = rng.randn(V, H) * 0.02
    if not (gemma or name in ('starcoder2', 'minicpm')):
        t['output.weight' if name == 'internlm2' else 'lm_head.weight'] = rng.randn(V, H) * 0.02
    norm('model.norm', bias=name == 'starcoder2')
    for layer in range(L):
        p = f'model.layers.{layer}.'
        if name == 'internlm2':
            norm(p + 'attention_norm')
            norm(p + 'ffn_norm')
            lin(p + 'attention.wqkv', qo + 2 * ko, H)
            lin(p + 'attention.wo', H, qo)
            lin(p + 'feed_forward.w1', I, H)
            lin(p + 'feed_forward.w3', I, H)
            lin(p + 'feed_forward.w2', H, I)
            continue
        norm(p + 'input_layernorm', bias=name == 'starcoder2')
        norm(p + 'post_attention_layernorm', bias=name == 'starcoder2')
        if name in ('gemma2', 'gemma3'):
            norm(p + 'pre_feedforward_layernorm')
            norm(p + 'post_feedforward_layernorm')
        if name == 'glm4':
            norm(p + 'post_self_attn_layernorm')
            norm(p + 'post_mlp_layernorm')
        if name == 'gemma3':
            norm(p + 'self_attn.q_norm', D)
            norm(p + 'self_attn.k_norm', D)
        bias = c.get('attention_bias', False) or name in ('internlm', 'starcoder2')
        if name == 'phi3':
            lin(p + 'self_attn.qkv_proj', qo + 2 * ko, H)
        elif name == 'baichuan':
            lin(p + 'self_attn.W_pack', qo + 2 * ko, H)
        else:
            lin(p + 'self_attn.q_proj', qo, H, bias)
            lin(p + 'self_attn.k_proj', ko, H, bias)
            lin(p + 'self_attn.v_proj', ko, H, bias)
        lin(p + 'self_attn.o_proj', H, qo, name in ('internlm', 'starcoder2'))
        if name == 'starcoder2':
            lin(p + 'mlp.c_fc', I, H, True)
            lin(p + 'mlp.c_proj', H, I, True)
        elif name in ('phi3', 'glm4', 'glm'):
            lin(p + 'mlp.gate_up_proj', 2 * I, H)
            lin(p + 'mlp.down_proj', H, I)
        else:
            lin(p + 'mlp.gate_proj', I, H)
            lin(p + 'mlp.up_proj', I, H)
            lin(p + 'mlp.down_proj', H, I)
    return t


def write_checkpoint(path, name: str, seed: int = 11) -> str:
    from safetensors.numpy import save_file
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(CFGS[name], f)
    make_tiny_tokenizer(str(path), vocab_size=V)
    t = _tensors(name, np.random.RandomState(seed))
    save_file({k: np.ascontiguousarray(np.asarray(v, np.float32)) for k, v in t.items()},
              os.path.join(path, 'model.safetensors'))
    return str(path)


def models(path):
    """(JAX model, its loaded numpy tree, port model, the port's loaded tree)."""
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu.weight_loader import load_params_np
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models import build_model as tbuild
    from lmdeploy_tpu_torch.weight_loader import load_params
    jm = jbuild(JConfig.from_pretrained(path, dtype='float32'))
    tm = tbuild(TConfig.from_pretrained(path, dtype='float32'))
    return jm, load_params_np(jm, path), tm, load_params(tm, path, 'cpu')


def tree_equal(tp, jp, path=''):
    """The port's tree equals the reference's, leaf for leaf, but for the reference's
    ``layer_window`` constant (the port's windows are Python ints)."""
    jp = {k: v for k, v in jp.items() if k != 'layer_window'}
    assert set(tp) == set(jp), (path, sorted(set(tp) ^ set(jp)))
    for name, leaf in tp.items():
        if isinstance(leaf, dict):
            tree_equal(leaf, jp[name], path + '/' + name)
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jp[name]),
                                          err_msg=path + '/' + name)


def check_logits(path, prompt_len: int = 64, decode_steps: int = 2):
    """Two rows, f32, on the JAX loader's tree: a fresh prefill (row 0 whole, row 1's
    first chunk), row 1's second chunk over the cache, then decode steps; every valid
    row's logits within ``ATOL`` of the JAX model's.  Rows past a window pass
    ``prompt_len`` > ``WINDOW``."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference, params_from_jax
    jm, jp, tm, _ = models(path)
    tp = tm.fuse_projections(params_from_jax(jp, dtype=torch.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    cfg = jm.config
    L, BS, NB, hkv, hd = cfg.num_layers, 16, 14, cfg.num_key_value_heads, cfg.head_dim
    _, hdp = kv_row_width(hkv, hd)
    jcache = jnp.zeros((L, NB, 2, BS, hdp), jnp.float32)
    tcache = cache_from_reference(np.asarray(jcache), hkv, hd)
    jcos, jsin = jrope(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling)
    tcos, tsin = trope(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling)
    tables = np.array([[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]], np.int32)
    ids = np.random.RandomState(0).randint(3, V, size=(2, prompt_len + 8)).astype(np.int32)
    half = prompt_len // 2
    steps = [((0, 0), (prompt_len, half), prompt_len, True),
             ((prompt_len, half), (0, prompt_len - half), prompt_len - half, False)] + [
        ((prompt_len + i, prompt_len + i), (1, 1), 1, False) for i in range(decode_steps)]
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
        np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], rtol=0, atol=ATOL)


def greedy(pkg: str, path: str, prompts, new_tokens: int = 8):
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


def check_engine_tokens(path):
    """Two concurrent prompts (the 70-token one in two prefill chunks, past the window
    of a windowed family), 8 greedy tokens each: the port's Engine gives the JAX
    Engine's tokens."""
    rng = np.random.RandomState(5)
    prompts = [rng.randint(3, V, size=n).tolist() for n in (30, 70)]
    ref = greedy('jax', path, prompts)
    out = greedy('torch', path, prompts)
    assert out == ref
    assert all(len(t) == 8 for t in out)
