"""The port's pipeline() against lmdeploy_tpu.pipeline() on the tiny checkpoint:
chat template, tokenizer, engine and detokenizer end to end, exact greedy tokens."""
import pytest


@pytest.fixture(scope='module')
def prompts():
    return ['hello world', 'this is a tiny test', 'hi']


def run(pipeline_fn, path, prompts, **kw):
    pipe = pipeline_fn(path, **kw)
    try:
        gen = pipe_gen(pipeline_fn)
        out = pipe(prompts, gen_config=gen)
        streamed = [o.token_ids for o in pipe.stream_infer(prompts[0], gen_config=gen)]
    finally:
        pipe.close()
    return out, [t for chunk in streamed for t in chunk]


def pipe_gen(pipeline_fn):
    if pipeline_fn.__module__.startswith('lmdeploy_tpu_torch'):
        from lmdeploy_tpu_torch.messages import GenerationConfig
    else:
        from lmdeploy_tpu.messages import GenerationConfig
    return GenerationConfig(max_new_tokens=8, ignore_eos=True)


def test_pipeline_greedy_matches_jax(tiny_model_dir, prompts):
    from lmdeploy_tpu import pipeline as jpipeline
    from lmdeploy_tpu.messages import TpuEngineConfig as JCfg
    from lmdeploy_tpu_torch import pipeline as tpipeline
    from lmdeploy_tpu_torch.messages import TpuEngineConfig as TCfg
    kw = dict(dtype='float32', block_size=16, num_gpu_blocks=64, max_batch_size=8,
              session_len=256)
    ref, ref_stream = run(jpipeline, tiny_model_dir, prompts, backend_config=JCfg(**kw))
    out, stream = run(tpipeline, tiny_model_dir, prompts, backend_config=TCfg(**kw),
                      device='cpu')
    assert [r.token_ids for r in out] == [r.token_ids for r in ref]
    assert [r.text for r in out] == [r.text for r in ref]
    assert [r.input_token_len for r in out] == [r.input_token_len for r in ref]
    assert all(r.generate_token_len == 8 and r.finish_reason == 'length' for r in out)
    assert stream == ref_stream == out[0].token_ids
