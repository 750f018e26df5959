"""Shared pieces of the port's MTP and DSA tests: tiny checkpoints of the reference's
fixtures (tests/test_mtp.py's DeepSeek and GLM-4.5 MTP checkpoints, test_deepseek_v32.py's
``DSV32_CFG``, test_glm_moe_dsa.py's ``GLM_DSA_CFG`` with its ``indexer_types``), copied
and written by one function per family, with the MTP layer appended where asked, its
linears in native blocked fp8 where asked; and models and engines of both packages."""
import json
import os

import numpy as np

from conftest import make_tiny_tokenizer
from test_deepseek import DS_CFG
from test_moe_quant import _quantize_blocked

GLM4_MTP_CFG = {
    'architectures': ['Glm4MoeForCausalLM'], 'model_type': 'glm4_moe',
    'hidden_size': 48, 'intermediate_size': 96, 'moe_intermediate_size': 32,
    'num_hidden_layers': 2, 'first_k_dense_replace': 1, 'num_attention_heads': 4,
    'num_key_value_heads': 2, 'head_dim': 16, 'partial_rotary_factor': 0.5,
    'attention_bias': False, 'use_qk_norm': True, 'n_routed_experts': 4,
    'n_shared_experts': 1, 'num_experts_per_tok': 2, 'n_group': 2, 'topk_group': 1,
    'norm_topk_prob': True, 'routed_scaling_factor': 1.0, 'num_nextn_predict_layers': 1,
    'vocab_size': 128, 'max_position_embeddings': 256, 'rms_norm_eps': 1e-5,
    'rope_theta': 10000.0, 'bos_token_id': 1, 'eos_token_id': 2,
    'tie_word_embeddings': False, 'torch_dtype': 'float32',
}
DSV32_CFG = {
    'architectures': ['DeepseekV32ForCausalLM'], 'model_type': 'deepseek_v32',
    'hidden_size': 64, 'intermediate_size': 128, 'moe_intermediate_size': 32,
    'num_hidden_layers': 2, 'first_k_dense_replace': 2, 'num_attention_heads': 4,
    'num_key_value_heads': 4, 'qk_nope_head_dim': 16, 'qk_rope_head_dim': 8,
    'v_head_dim': 16, 'q_lora_rank': 32, 'kv_lora_rank': 24, 'index_n_heads': 4,
    'index_head_dim': 16, 'index_topk': 256, 'vocab_size': 128,
    'max_position_embeddings': 256, 'rms_norm_eps': 1e-6, 'rope_theta': 10000.0,
    'bos_token_id': 1, 'eos_token_id': 2, 'tie_word_embeddings': False,
    'torch_dtype': 'float32',
}
GLM_DSA_CFG = {
    'architectures': ['GlmMoeDsaForCausalLM'], 'model_type': 'glm_moe_dsa',
    'hidden_size': 64, 'intermediate_size': 128, 'moe_intermediate_size': 32,
    'num_hidden_layers': 4, 'first_k_dense_replace': 1, 'n_routed_experts': 4,
    'n_shared_experts': 1, 'num_experts_per_tok': 2, 'norm_topk_prob': True,
    'routed_scaling_factor': 1.0, 'scoring_func': 'sigmoid', 'num_attention_heads': 4,
    'num_key_value_heads': 4, 'qk_nope_head_dim': 16, 'qk_rope_head_dim': 8,
    'qk_head_dim': 24, 'v_head_dim': 16, 'q_lora_rank': 32, 'kv_lora_rank': 24,
    'index_n_heads': 4, 'index_head_dim': 16, 'index_topk': 256,
    'indexer_types': ['full', 'shared', 'full', 'shared'], 'vocab_size': 128,
    'max_position_embeddings': 256, 'rms_norm_eps': 1e-6, 'rope_theta': 10000.0,
    'bos_token_id': 1, 'eos_token_id': 2, 'tie_word_embeddings': False,
    'torch_dtype': 'float32',
}
# the reference's V3 MTP fixture is DS_CFG (V2 routing); 'v3' adds V3's sigmoid routing,
# groups and q_lora, the form the blocked-fp8 and V3.2 cases take
CFGS = {'ds': DS_CFG,
        'v3': dict(DS_CFG, architectures=['DeepseekV3ForCausalLM'], model_type='deepseek_v3',
                   scoring_func='sigmoid', n_group=2, topk_group=1, q_lora_rank=32,
                   routed_scaling_factor=2.5, num_hidden_layers=2),
        'glm4': GLM4_MTP_CFG, 'v32': DSV32_CFG, 'glm_dsa': GLM_DSA_CFG}
FP8_BLOCK = 32
# the engine cases: three concurrent prompts in one 16-token chunk bucket, 6 greedy
# tokens each, K = 3
MTP_SPEC = dict(method='deepseek_mtp', num_speculative_tokens=3)
PROMPT_LENS = (6, 14, 9)
NEW = 6


def write_checkpoint(path, name, mtp=False, fp8=False, seed=11, **over):
    """A tiny f32 checkpoint of CFGS[name] (with ``over`` on its config); ``mtp``
    appends the MTP layer ``model.layers.{L}.*``; ``fp8`` stores every linear in native
    blocked fp8 (32 x 32 blocks, DeepSeek-V3's release form)."""
    from safetensors.numpy import save_file
    c = dict(CFGS[name], **over)
    if mtp:
        c['num_nextn_predict_layers'] = 1
    if fp8:
        c['quantization_config'] = {'quant_method': 'fp8', 'fmt': 'e4m3',
                                    'weight_block_size': [FP8_BLOCK, FP8_BLOCK]}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(c, f)
    make_tiny_tokenizer(str(path), vocab_size=128)
    rng = np.random.RandomState(seed)
    H, V, L = c['hidden_size'], c['vocab_size'], c['num_hidden_layers']
    t = {'model.embed_tokens.weight': rng.randn(V, H) * 0.02,
         'model.norm.weight': np.ones(H), 'lm_head.weight': rng.randn(V, H) * 0.02}

    def lin(prefix, out_dim, in_dim, scale=0.05):
        w = (rng.randn(out_dim, in_dim) * scale).astype(np.float32)
        if fp8:
            t[prefix + '.weight'], t[prefix + '.weight_scale_inv'] = \
                _quantize_blocked(w, FP8_BLOCK, FP8_BLOCK)
        else:
            t[prefix + '.weight'] = w

    def attention(p, layer):
        a = p + 'self_attn.'
        if name == 'glm4':
            nh, nkv, D = c['num_attention_heads'], c['num_key_value_heads'], c['head_dim']
            for n, od in (('q', nh * D), ('k', nkv * D), ('v', nkv * D)):
                lin(a + f'{n}_proj', od, H)
            lin(a + 'o_proj', H, nh * D)
            t[a + 'q_norm.weight'] = np.ones(D)
            t[a + 'k_norm.weight'] = np.ones(D)
            return
        nh, dn, dr, dv, r = (c['num_attention_heads'], c['qk_nope_head_dim'],
                             c['qk_rope_head_dim'], c['v_head_dim'], c['kv_lora_rank'])
        rq = c.get('q_lora_rank')
        if rq:
            lin(a + 'q_a_proj', rq, H)
            t[a + 'q_a_layernorm.weight'] = np.ones(rq)
            lin(a + 'q_b_proj', nh * (dn + dr), rq)
        else:
            lin(a + 'q_proj', nh * (dn + dr), H)
        lin(a + 'kv_a_proj_with_mqa', r + dr, H)
        t[a + 'kv_a_layernorm.weight'] = np.ones(r)
        lin(a + 'kv_b_proj', nh * (dn + dv), r)
        lin(a + 'o_proj', H, nh * dv)
        types = c.get('indexer_types') or []
        if 'index_n_heads' in c and (layer >= len(types) or types[layer] == 'full'):
            hI, dI = c['index_n_heads'], c['index_head_dim']
            lin(a + 'indexer.wq_b', hI * dI, rq)
            lin(a + 'indexer.wk', dI, H)
            t[a + 'indexer.k_norm.weight'] = 1.0 + rng.randn(dI) * 0.1
            t[a + 'indexer.k_norm.bias'] = rng.randn(dI) * 0.1
            t[a + 'indexer.weights_proj.weight'] = rng.randn(hI, H) * 0.05

    def mlp(p, moe):
        if not moe:
            inter = c['intermediate_size']
            lin(p + 'mlp.gate_proj', inter, H)
            lin(p + 'mlp.up_proj', inter, H)
            lin(p + 'mlp.down_proj', H, inter)
            return
        E, ie = c['n_routed_experts'], c['moe_intermediate_size']
        t[p + 'mlp.gate.weight'] = rng.randn(E, H) * 0.05
        t[p + 'mlp.gate.e_score_correction_bias'] = rng.randn(E) * 0.05
        for e in range(E):
            for hf, od, idim in (('gate_proj', ie, H), ('up_proj', ie, H),
                                 ('down_proj', H, ie)):
                lin(p + f'mlp.experts.{e}.{hf}', od, idim)
        shared = c['n_shared_experts'] * ie
        lin(p + 'mlp.shared_experts.gate_proj', shared, H)
        lin(p + 'mlp.shared_experts.up_proj', shared, H)
        lin(p + 'mlp.shared_experts.down_proj', H, shared)

    for layer in range(L + (1 if mtp else 0)):
        p = f'model.layers.{layer}.'
        t[p + 'input_layernorm.weight'] = np.ones(H)
        t[p + 'post_attention_layernorm.weight'] = np.ones(H)
        if layer == L:                     # the MTP layer
            t[p + 'enorm.weight'] = 1.0 + rng.randn(H) * 0.1
            t[p + 'hnorm.weight'] = 1.0 + rng.randn(H) * 0.1
            lin(p + 'eh_proj', H, 2 * H)
            t[p + 'shared_head.norm.weight'] = 1.0 + rng.randn(H) * 0.1
        attention(p, layer)
        mlp(p, layer >= c['first_k_dense_replace'] and c.get('n_routed_experts'))
    t = {k: np.ascontiguousarray(v if v.dtype.name == 'float8_e4m3fn'
                                 else v.astype(np.float32)) for k, v in t.items()}
    save_file(t, os.path.join(path, 'model.safetensors'))
    return str(path)


def jax_model(path, cls=None, dtype='float32'):
    """(the JAX model, or ``cls`` on its config, and its numpy params)."""
    import jax
    from lmdeploy_tpu.config import ModelConfig
    from lmdeploy_tpu.models import build_model
    from lmdeploy_tpu.weight_loader import load_model_params
    cfg = ModelConfig.from_pretrained(path, dtype=dtype)
    model = build_model(cfg)
    if cls is not None:
        model = cls(cfg)
    return model, jax.tree_util.tree_map(np.asarray, load_model_params(model, path))


def torch_model(path, cls=None, dtype='float32'):
    """(the port's model, or ``cls`` on its config, and its params on the CPU)."""
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    from lmdeploy_tpu_torch.weight_loader import load_params
    cfg = ModelConfig.from_pretrained(path, dtype=dtype)
    model = build_model(cfg)
    if cls is not None:
        model = cls(cfg)
    return model, load_params(model, path, 'cpu')


def mtp_heads():
    """{case: (the reference's MTP class, the port's)}."""
    from lmdeploy_tpu.models.deepseek import DeepseekMTP as JD
    from lmdeploy_tpu.models.glm4_moe import Glm4MoeMTP as JG
    from lmdeploy_tpu.models.glm_moe_dsa import GlmMoeDsaMTP as JGD
    from lmdeploy_tpu_torch.models.mtp import DeepseekMTP, Glm4MoeMTP, GlmMoeDsaMTP
    return {'ds': (JD, DeepseekMTP), 'glm4': (JG, Glm4MoeMTP),
            'glm_dsa': (JGD, GlmMoeDsaMTP), 'v32': (JD, DeepseekMTP)}


def prompts():
    import spec_cases as sc
    return [[t % 120 + 3 for t in p] for p in sc.make_prompts(5, PROMPT_LENS)]


def check_mtp_engine(name, path, policy):
    """The port's deepseek_mtp engine on a concurrent batch: its tokens and each
    step's emitted counts are the JAX speculative engine's; the head is the family's,
    one layer, its cache in the model dtype."""
    import spec_cases as sc
    import torch
    ps = prompts()
    ref, ref_emitted = sc.spec_run('jax', path, ps, NEW, MTP_SPEC, quant_policy=policy)
    engine = sc.build('torch', path, MTP_SPEC, quant_policy=policy)
    emitted = []
    step = engine.spec.spec_decode
    engine.spec.spec_decode = lambda n: emitted.append(step(n)) or emitted[-1]
    try:
        got = [o.token_ids for o in sc.serve(engine, ps, NEW)]
        assert isinstance(engine.spec.draft_model, mtp_heads()[name][1])
        assert engine.spec.draft_kv.shape[0] == 1
        assert engine.spec.draft_kv.dtype == torch.float32
    finally:
        engine.close()
    assert got == ref and all(len(t) == NEW for t in got)
    assert [e[1].tolist() for e in emitted] == ref_emitted
