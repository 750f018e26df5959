"""The dense Qwen3.5 twin (``hybrid_cases.write_qwen3_5(moe=False)``) through the
port's ``pipeline()`` against the JAX Engine: exact greedy tokens."""
import hybrid_cases as hc

SMALL = dict(block_size=64, session_len=128, decode_buckets=[4], prefill_buckets=[32])


def test_dense_pipeline_matches_jax_engine(tmp_path):
    """The dense twin (``Qwen3_5ForConditionalGeneration``, text only) through the
    port's ``pipeline()`` (tokenizer, engine, detokenizer) gives the JAX Engine's greedy
    tokens on the prompts' ids."""
    from lmdeploy_tpu_torch import pipeline
    from lmdeploy_tpu_torch.messages import GenerationConfig, TpuEngineConfig
    from lmdeploy_tpu_torch.tokenizer import Tokenizer
    path = hc.write_qwen3_5(str(tmp_path / 'dense'), moe=False, with_vision=False,
                            interval=2, tokenizer=True)
    prompts = ['hello world', 'this is a tiny test']
    ids = [Tokenizer(path).encode(p) for p in prompts]
    ref, _ = hc.run('jax', path, [ids], 8, **SMALL)
    pipe = pipeline(path, backend_config=TpuEngineConfig(**dict(hc.ENGINE_KW, **SMALL)),
                    device='cpu')
    try:
        out = pipe(prompts, gen_config=GenerationConfig(max_new_tokens=8, ignore_eos=True),
                   do_preprocess=False)
    finally:
        pipe.close()
    assert [r.token_ids for r in out] == ref and all(len(t) == 8 for t in ref)
    assert [r.input_token_len for r in out] == [len(i) for i in ids]
