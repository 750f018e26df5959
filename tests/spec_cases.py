"""Shared pieces of the port's speculative-decoding tests: tiny EAGLE / EAGLE-3 head
checkpoints at the tiny llama's geometry (the reference's test_spec_decode_e2e.py
fixtures, copied), and engines of both packages with a speculative config."""
import asyncio
import json
import os

import numpy as np

ENGINE_KW = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=4,
                 session_len=256, max_prefill_token_num=64)
H, I, NH, NKV, HD, V, DV = 64, 128, 4, 2, 16, 256, 64
HEAD_CFG = {'architectures': ['LlamaForCausalLM'], 'model_type': 'llama',
            'hidden_size': H, 'intermediate_size': I, 'num_hidden_layers': 1,
            'num_attention_heads': NH, 'num_key_value_heads': NKV, 'head_dim': HD,
            'vocab_size': V, 'max_position_embeddings': 512, 'rms_norm_eps': 1e-6,
            'rope_theta': 10000.0, 'torch_dtype': 'float32'}
EAGLE3_CFG = dict(HEAD_CFG, architectures=['LlamaForCausalLMEagle3'],
                  draft_vocab_size=DV, target_hidden_size=H)


def _save(path, cfg, tensors):
    from safetensors.numpy import save_file
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, 'config.json'), 'w') as f:
        json.dump(cfg, f)
    save_file(tensors, os.path.join(path, 'model.safetensors'))
    return str(path)


def write_eagle(path):
    """A random EAGLE-1 head (fc [H, 2H], one layer without an input norm)."""
    rng = np.random.RandomState(21)
    t = {'fc.weight': rng.randn(H, 2 * H) * 0.05,
         'layers.0.self_attn.q_proj.weight': rng.randn(NH * HD, H) * 0.05,
         'layers.0.self_attn.k_proj.weight': rng.randn(NKV * HD, H) * 0.05,
         'layers.0.self_attn.v_proj.weight': rng.randn(NKV * HD, H) * 0.05,
         'layers.0.self_attn.o_proj.weight': rng.randn(H, NH * HD) * 0.05,
         'layers.0.post_attention_layernorm.weight': np.ones(H),
         'layers.0.mlp.gate_proj.weight': rng.randn(I, H) * 0.05,
         'layers.0.mlp.up_proj.weight': rng.randn(I, H) * 0.05,
         'layers.0.mlp.down_proj.weight': rng.randn(H, I) * 0.05}
    return _save(path, HEAD_CFG,
                 {k: np.ascontiguousarray(v.astype(np.float32)) for k, v in t.items()})


def write_eagle3(path, embed=True):
    """A random EAGLE-3 head: 2H-wide qkv, a 3H fc, a draft vocabulary of DV ids and
    d2t stored as offsets (sorted, so the absolute ids are unique)."""
    rng = np.random.RandomState(31)
    d2t = np.sort(rng.choice(V, size=DV, replace=False)).astype(np.int64) - np.arange(DV)
    t = {'embed_tokens.weight': rng.randn(V, H) * 0.05,
         'fc.weight': rng.randn(H, 3 * H) * 0.05,
         'midlayer.input_layernorm.weight': np.ones(H) + rng.randn(H) * 0.1,
         'midlayer.hidden_norm.weight': np.ones(H) + rng.randn(H) * 0.1,
         'midlayer.self_attn.q_proj.weight': rng.randn(NH * HD, 2 * H) * 0.05,
         'midlayer.self_attn.k_proj.weight': rng.randn(NKV * HD, 2 * H) * 0.05,
         'midlayer.self_attn.v_proj.weight': rng.randn(NKV * HD, 2 * H) * 0.05,
         'midlayer.self_attn.o_proj.weight': rng.randn(H, NH * HD) * 0.05,
         'midlayer.post_attention_layernorm.weight': np.ones(H),
         'midlayer.mlp.gate_proj.weight': rng.randn(I, H) * 0.05,
         'midlayer.mlp.up_proj.weight': rng.randn(I, H) * 0.05,
         'midlayer.mlp.down_proj.weight': rng.randn(H, I) * 0.05,
         'norm.weight': np.ones(H),
         'lm_head.weight': rng.randn(DV, H) * 0.05}
    if not embed:
        del t['embed_tokens.weight']
    t = {k: np.ascontiguousarray(v.astype(np.float32)) for k, v in t.items()}
    t['d2t'] = np.ascontiguousarray(d2t)
    return _save(path, EAGLE3_CFG, t)


def make_prompts(seed, lengths):
    rng = np.random.RandomState(seed)
    return [rng.randint(3, 250, size=n).tolist() for n in lengths]


def build(pkg, path, spec=None, **cfg):
    """An engine of ``pkg`` ('jax' or 'torch', the latter on the CPU) with the
    speculative config ``spec`` (a dict of SpeculativeConfig fields, or None)."""
    if pkg == 'jax':
        from lmdeploy_tpu.engine.engine import Engine
        from lmdeploy_tpu.messages import SpeculativeConfig, TpuEngineConfig
        kw = {}
    else:
        from lmdeploy_tpu_torch.engine.engine import Engine
        from lmdeploy_tpu_torch.messages import SpeculativeConfig, TpuEngineConfig
        kw = {'device': 'cpu'}
    return Engine.from_pretrained(
        path, TpuEngineConfig(**dict(ENGINE_KW, **cfg)),
        speculative_config=None if spec is None else SpeculativeConfig(**spec), **kw)


def serve(engine, prompts, new_tokens, gen_kw=None, first_session=1):
    """Serve the prompts concurrently; returns each request's output (EngineOutput)."""
    if type(engine).__module__.startswith('lmdeploy_tpu_torch'):
        from lmdeploy_tpu_torch.messages import GenerationConfig
    else:
        from lmdeploy_tpu.messages import GenerationConfig
    gen_kw = gen_kw if isinstance(gen_kw, list) else [gen_kw] * len(prompts)
    inst = engine.create_instance()

    async def go():
        return await asyncio.gather(*[
            inst.async_infer(first_session + i, p, GenerationConfig(
                max_new_tokens=new_tokens, ignore_eos=True, **(g or {})))
            for i, (p, g) in enumerate(zip(prompts, gen_kw))])
    return asyncio.run(go())


def tokens(pkg, path, prompts, new_tokens, spec=None, gen_kw=None, **cfg):
    """Each prompt's tokens from a fresh engine, closed afterwards."""
    return spec_run(pkg, path, prompts, new_tokens, spec, gen_kw, **cfg)[0]


def spec_run(pkg, path, prompts, new_tokens, spec=None, gen_kw=None, **cfg):
    """(each prompt's tokens, the emitted counts [B] of every speculative step) from a
    fresh engine, closed afterwards."""
    engine = build(pkg, path, spec, **cfg)
    emitted = []
    if engine.spec is not None:
        step = engine.spec.spec_decode

        def counted(num_rows):
            out = step(num_rows)
            emitted.append(np.asarray(out[1]).tolist())
            return out
        engine.spec.spec_decode = counted
    try:
        return [o.token_ids for o in serve(engine, prompts, new_tokens, gen_kw)], emitted
    finally:
        engine.close()
