"""Shared pieces of the port's hybrid linear-attention tests: tiny Qwen3-Next checkpoints
under transformers' names and config (``Qwen3NextForCausalLM``, written with numpy: the
weights are seeded, the zero-centred norms random so a missing +1 shows), their Qwen3.5
twins (split projections, fused or per-expert expert tensors, the
``model.language_model.`` prefix, a nested ``text_config`` beside a ``vision_config``;
the layout the reference's test_qwen3_5.py writes), and the two packages' models and
engines on them."""
import json
import os

import numpy as np

GEOM = dict(
    hidden_size=64, intermediate_size=96,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    head_dim=32,
    linear_num_key_heads=2, linear_num_value_heads=4,
    linear_key_head_dim=16, linear_value_head_dim=16,
    linear_conv_kernel_dim=4,
    num_experts=4, num_experts_per_tok=2, moe_intermediate_size=32,
    shared_expert_intermediate_size=48,
    norm_topk_prob=True,
    vocab_size=128, partial_rotary_factor=0.25,
    rope_theta=10000.0, max_position_embeddings=512,
    rms_norm_eps=1e-6, tie_word_embeddings=False,
    bos_token_id=1, eos_token_id=2,
)
HK, HV, DK, DV = 2, 4, 16, 16
R = HV // HK
KD, VD = HK * DK, HV * DV
TINY_VISION = dict(
    depth=2, hidden_size=32, num_heads=2, patch_size=4,
    spatial_merge_size=2, temporal_patch_size=1, in_channels=3,
    intermediate_size=48, out_hidden_size=64, num_position_embeddings=16,
)
ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=48, max_batch_size=4,
                 session_len=256, max_prefill_token_num=64)
# the engine tests' configuration (4 batch slots; 4 usable blocks of 64 slots; one
# 64-token prefill bucket, so every prefill chunk takes the chunked form and decode the
# scan; one decode bucket: few JAX programs to compile) and a roomy one without prefix
# caching
ENGINE_CFG = dict(block_size=64, num_gpu_blocks=5, session_len=128,
                  enable_prefix_caching=True, decode_buckets=[4], prefill_buckets=[64])
ROOMY = dict(ENGINE_CFG, num_gpu_blocks=16, enable_prefix_caching=False)


def layer_types(interval: int = 4, layers: int = 4):
    return (['linear_attention'] * (interval - 1) + ['full_attention']) * (layers // interval)


def next_state_dict(seed: int = 3, layers: int = 4, interval: int = 4) -> dict:
    """A seeded Qwen3-Next state dict under transformers' names and shapes (a block of
    ``interval`` layers: interval - 1 gated-DeltaNet layers, then full attention)."""
    rng = np.random.RandomState(seed)
    H, E, I, SI = (GEOM['hidden_size'], GEOM['num_experts'],
                   GEOM['moe_intermediate_size'], GEOM['shared_expert_intermediate_size'])
    NH, NKV, D, V = (GEOM['num_attention_heads'], GEOM['num_key_value_heads'],
                     GEOM['head_dim'], GEOM['vocab_size'])
    conv_dim = 2 * KD + VD

    def r(*shape, s=0.08):
        return (rng.randn(*shape) * s).astype(np.float32)
    sd = {'model.embed_tokens.weight': r(V, H, s=0.5), 'model.norm.weight': r(H, s=0.1),
          'lm_head.weight': r(V, H, s=0.15)}
    for l in range(layers):
        p = f'model.layers.{l}.'
        sd[p + 'input_layernorm.weight'] = r(H, s=0.1)
        sd[p + 'post_attention_layernorm.weight'] = r(H, s=0.1)
        if layer_types(interval, layers)[l] == 'linear_attention':
            q = p + 'linear_attn.'
            sd[q + 'in_proj_qkvz.weight'] = r(2 * KD + 2 * VD, H, s=0.15)
            sd[q + 'in_proj_ba.weight'] = r(2 * HV, H, s=0.3)
            sd[q + 'conv1d.weight'] = r(conv_dim, 1, 4, s=0.4)
            sd[q + 'A_log'] = np.log(rng.uniform(0.5, 4.0, HV)).astype(np.float32)
            sd[q + 'dt_bias'] = (1.0 + rng.randn(HV) * 0.2).astype(np.float32)
            sd[q + 'norm.weight'] = (1.0 + rng.randn(DV) * 0.1).astype(np.float32)
            sd[q + 'out_proj.weight'] = r(H, VD, s=0.15)
        else:
            a = p + 'self_attn.'
            sd[a + 'q_proj.weight'] = r(NH * 2 * D, H, s=0.15)
            sd[a + 'k_proj.weight'] = r(NKV * D, H, s=0.15)
            sd[a + 'v_proj.weight'] = r(NKV * D, H, s=0.15)
            sd[a + 'o_proj.weight'] = r(H, NH * D, s=0.15)
            sd[a + 'q_norm.weight'] = r(D, s=0.1)
            sd[a + 'k_norm.weight'] = r(D, s=0.1)
        m = p + 'mlp.'
        sd[m + 'gate.weight'] = r(E, H, s=0.3)
        for e in range(E):
            sd[m + f'experts.{e}.gate_proj.weight'] = r(I, H, s=0.15)
            sd[m + f'experts.{e}.up_proj.weight'] = r(I, H, s=0.15)
            sd[m + f'experts.{e}.down_proj.weight'] = r(H, I, s=0.15)
        sd[m + 'shared_expert.gate_proj.weight'] = r(SI, H, s=0.15)
        sd[m + 'shared_expert.up_proj.weight'] = r(SI, H, s=0.15)
        sd[m + 'shared_expert.down_proj.weight'] = r(H, SI, s=0.15)
        sd[m + 'shared_expert_gate.weight'] = r(1, H, s=0.3)
    return sd


def _save(path: str, cfg: dict, tensors: dict) -> str:
    from safetensors.numpy import save_file
    os.makedirs(path, exist_ok=True)
    save_file({k: np.ascontiguousarray(v) for k, v in tensors.items()},
              os.path.join(path, 'model.safetensors'))
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(cfg, f)
    return path


def write_qwen3_next(path: str, seed: int = 3, interval: int = 4) -> str:
    """A tiny Qwen3NextForCausalLM checkpoint (config.json as transformers writes it:
    ``layer_types``, ``full_attention_interval``, ``decoder_sparse_step``)."""
    cfg = dict(GEOM, architectures=['Qwen3NextForCausalLM'], model_type='qwen3_next',
               layer_types=layer_types(interval), full_attention_interval=interval,
               decoder_sparse_step=1, mlp_only_layers=[], torch_dtype='float32')
    return _save(path, cfg, next_state_dict(seed, interval=interval))


def _split_linear_attn(sd: dict, l: int) -> dict:
    """Qwen3-Next's fused per-key-head projections -> Qwen3.5's split tensors."""
    p = f'model.layers.{l}.linear_attn.'
    qkvz = sd[p + 'in_proj_qkvz.weight'].reshape(HK, 2 * DK + 2 * R * DV, -1)
    H = qkvz.shape[-1]
    ba = sd[p + 'in_proj_ba.weight'].reshape(HK, 2 * R, H)
    return {
        'in_proj_qkv.weight': np.concatenate(
            [qkvz[:, :DK].reshape(KD, H), qkvz[:, DK:2 * DK].reshape(KD, H),
             qkvz[:, 2 * DK:2 * DK + R * DV].reshape(VD, H)], axis=0),
        'in_proj_z.weight': qkvz[:, 2 * DK + R * DV:].reshape(VD, H),
        'in_proj_b.weight': ba[:, :R].reshape(HV, H),
        'in_proj_a.weight': ba[:, R:].reshape(HV, H),
    }


def write_qwen3_5(path: str, seed: int = 3, moe: bool = True, fused_experts: bool = True,
                  with_vision: bool = True, interval: int = 4, tokenizer: bool = False) -> str:
    """The Qwen3.5 twin of ``write_qwen3_next(seed)`` (the same network): MoE
    (``Qwen3_5MoeForConditionalGeneration``) with fused or per-expert expert tensors, or
    dense (``Qwen3_5ForConditionalGeneration``, a seeded gate / up / down mlp in place of
    the MoE); the LM under ``model.language_model.`` and ``text_config``, a
    ``vision_config`` beside it (and, with ``tokenizer``, the tiny test tokenizer)."""
    sd = next_state_dict(seed, interval=interval)
    types = layer_types(interval)
    rng = np.random.RandomState(seed + 100)
    L, E, H, I = (GEOM['num_hidden_layers'], GEOM['num_experts'], GEOM['hidden_size'],
                  GEOM['intermediate_size'])
    out = {}
    for name, w in sd.items():
        if name == 'lm_head.weight':
            out[name] = w
            continue
        if name.startswith('model.layers.'):
            rest = name.split('.', 3)[3]
            if (rest.startswith('linear_attn.in_proj') or (not moe and rest.startswith('mlp.'))
                    or (fused_experts and '.experts.' in rest)):
                continue
        out['model.language_model.' + name[len('model.'):]] = w
    for l in range(L):
        dst = f'model.language_model.layers.{l}.'
        if types[l] == 'linear_attention':
            for k, w in _split_linear_attn(sd, l).items():
                out[dst + 'linear_attn.' + k] = w
        src = f'model.layers.{l}.mlp.experts.'
        if not moe:
            for hf, shape in (('gate_proj', (I, H)), ('up_proj', (I, H)),
                              ('down_proj', (H, I))):
                out[dst + f'mlp.{hf}.weight'] = (rng.randn(*shape) * 0.1).astype(np.float32)
        elif fused_experts:
            out[dst + 'mlp.experts.gate_up_proj'] = np.stack([np.concatenate(
                [sd[src + f'{e}.gate_proj.weight'], sd[src + f'{e}.up_proj.weight']])
                for e in range(E)])                                   # [E, 2I, H]
            out[dst + 'mlp.experts.down_proj'] = np.stack(
                [sd[src + f'{e}.down_proj.weight'] for e in range(E)])  # [E, H, I]
    if with_vision:
        # one vision tensor (the tower's position table), which the text model skips
        out['model.visual.pos_embed.weight'] = (rng.randn(16, 32) * 0.02).astype(np.float32)
    text_cfg = dict(GEOM, layer_types=types,
                    rope_scaling={'rope_type': 'default', 'mrope_section': [2, 1, 1],
                                  'mrope_interleaved': True})
    if not moe:
        for k in ('num_experts', 'num_experts_per_tok', 'moe_intermediate_size',
                  'shared_expert_intermediate_size'):
            text_cfg.pop(k)
    cfg = {'architectures': ['Qwen3_5MoeForConditionalGeneration' if moe
                             else 'Qwen3_5ForConditionalGeneration'],
           'model_type': 'qwen3_5_moe' if moe else 'qwen3_5',
           'text_config': text_cfg, 'torch_dtype': 'float32'}
    if with_vision:
        cfg['vision_config'] = dict(TINY_VISION)
        cfg['image_token_id'] = 120
    _save(path, cfg, out)
    if tokenizer:
        from conftest import make_tiny_tokenizer
        make_tiny_tokenizer(path, vocab_size=GEOM['vocab_size'])
    return path


def models(path: str):
    """(JAX model, JAX params, port model, port params) of a checkpoint, in f32; the
    JAX tree converted by ``weight_convert.params_from_jax`` is compared leaf by leaf
    with the port's own load by the loader tests."""
    import jax

    from lmdeploy_tpu.config import ModelConfig as JCfg
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu.weight_loader import load_params_np
    from lmdeploy_tpu_torch.config import ModelConfig
    from lmdeploy_tpu_torch.models import build_model
    from lmdeploy_tpu_torch.weight_loader import load_params
    jm = jbuild(JCfg.from_pretrained(path, dtype='float32'))
    jp = jax.tree_util.tree_map(np.asarray, load_params_np(jm, path))
    tm = build_model(ModelConfig.from_pretrained(path, dtype='float32'))
    tp = load_params(tm, path, 'cpu')
    return jm, jp, tm, tp


def prompts(seed: int, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 120, size=n).tolist() for n in lengths]


def build(pkg: str, path: str, **cfg):
    """An engine of ``pkg`` ('jax' or 'torch', the latter on the CPU) over ``path``."""
    if pkg == 'jax':
        from lmdeploy_tpu.engine.engine import Engine
        from lmdeploy_tpu.messages import TpuEngineConfig
        kw = {}
    else:
        from lmdeploy_tpu_torch.engine.engine import Engine
        from lmdeploy_tpu_torch.messages import TpuEngineConfig
        kw = {'device': 'cpu'}
    return Engine.from_pretrained(path, TpuEngineConfig(**dict(ENGINE_KW, **cfg)), **kw)



def count_prefill(engine):
    """Count the tokens the engine's prefill steps compute (``engine.computed``)."""
    agent = engine.model_agent
    prefill = agent.prefill
    engine.computed = 0

    def counted(chunks):
        engine.computed += sum(c.length for c in chunks)
        return prefill(chunks)
    agent.prefill = counted
    return engine


def serve_waves(engine, waves, new_tokens: int):
    """Serve ``waves`` (lists of prompts: each wave's prompts concurrently, the waves one
    after another), greedy; returns each prompt's tokens."""
    from spec_cases import serve
    out = []
    for wave in waves:
        first = getattr(engine, 'next_session', 1)
        out += [o.token_ids for o in serve(engine, wave, new_tokens, first_session=first)]
        engine.next_session = first + len(wave)
    return out


def stats(engine) -> dict:
    """Preemptions, prefill tokens computed (under ``count_prefill``) and the SSM
    checkpoint store's puts and hits, so far."""
    store = engine._ssm_ckpt
    return {'preemptions': engine.scheduler.num_preemptions,
            'computed': getattr(engine, 'computed', None),
            'ckpt': None if store is None else (store.puts, store.hits)}


def run(pkg: str, path: str, waves, new_tokens: int, **cfg):
    """``serve_waves`` on a fresh engine (closed afterwards): (tokens, ``stats``)."""
    engine = count_prefill(build(pkg, path, **cfg))
    try:
        return serve_waves(engine, waves, new_tokens), stats(engine)
    finally:
        engine.close()


def both(engines, waves, new_tokens: int):
    """``serve_waves`` on the JAX and the port engine of ``engines``: the tokens, equal,
    with equal scheduling so far (``stats``)."""
    ref = serve_waves(engines['jax'], waves, new_tokens)
    got = serve_waves(engines['torch'], waves, new_tokens)
    assert got == ref and all(len(t) == new_tokens for t in got)
    assert stats(engines['torch']) == stats(engines['jax'])
    return got


def engine_pair(path: str) -> dict:
    """Both packages' engines over ``path`` at ``ENGINE_CFG``, prefill tokens counted."""
    return {pkg: count_prefill(build(pkg, path, **ENGINE_CFG)) for pkg in ('jax', 'torch')}
