"""The port's MTP speculative decoding (``deepseek_mtp``) against the JAX package (CPU,
f32).

The reference tests' tiny MTP checkpoints (DeepSeek with V2 routing, GLM-4.5 with GQA
and partial rope, GLM-MoE-DSA with a DSA head; V3.2 as a target of the plain MLA head),
their MTP norms random so ``enorm`` / ``hnorm`` / ``shared_head.norm`` count: the
target's ``forward(return_hidden=True)`` logits and pre-norm features at 1e-5; each
head's loader exactly and two chained draft steps at 1e-5; the blocked-fp8 head the
reference loads without its scales, which the port refuses; and the proposer's expert
stacks in ``eager_reason``.  The engines are held in test_torch_mtp_engine.py (DeepSeek)
and test_torch_mtp_glm_engine.py (GLM-4.5, GLM-MoE-DSA, and the DSA engine).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mtp_dsa_cases as mc
import spec_cases as sc

SPEC = mc.MTP_SPEC


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp('mtp')
    out = {name: mc.write_checkpoint(str(root / name), name, mtp=True)
           for name in ('ds', 'glm4', 'v32')}
    out['glm_dsa'] = mc.write_checkpoint(str(root / 'glm_dsa'), 'glm_dsa', mtp=True,
                                         index_topk=8)
    return out


def _tree_equal(tp, jp, prefix=''):
    assert set(tp) == set(jp), prefix
    for name, leaf in tp.items():
        if isinstance(leaf, dict):
            _tree_equal(leaf, jp[name], prefix + name + '.')
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(jp[name]),
                                          err_msg=prefix + name)


@pytest.mark.parametrize('name', ['ds', 'glm4'])
def test_forward_features_match_jax(ckpt, name):
    """Two rows in one chunk (21 and 16 valid tokens): all logits and the pre-norm
    hidden at 1e-5; EAGLE-3's taps raise."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    jm, jp = mc.jax_model(ckpt[name])
    tm, tp = mc.torch_model(ckpt[name])
    cfg, jcfg = tm.config, jm.config
    B, T, BS = 2, 21, 16
    ids = np.random.RandomState(0).randint(3, 120, size=(B, T)).astype(np.int32)
    pos = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    tables = np.array([[1, 2], [3, 4]], np.int32)
    hist, q = np.zeros(B, np.int32), np.array([T, 16], np.int32)
    rowp = kv_row_width(jcfg.num_key_value_heads, jcfg.cache_head_dim)[1]
    fwd = jax.jit(jm.forward, static_argnames=('return_all_logits', 'return_hidden'))
    jl, _, jh = fwd(jp, jnp.asarray(ids), jnp.asarray(pos),
                    jnp.zeros((jcfg.num_layers, 8, 2, BS, rowp)),
                    JMeta(jnp.asarray(tables), jnp.asarray(hist), jnp.asarray(q)),
                    *jrope(jcfg.rope_dim, 256, jcfg.rope_theta, jcfg.rope_scaling),
                    return_all_logits=True, return_hidden=True)
    args = (tp, torch.from_numpy(ids), torch.from_numpy(pos),
            torch.zeros((cfg.num_layers, 8, 2, BS,
                         cfg.num_key_value_heads * cfg.cache_head_dim)),
            AttnMeta(*(torch.from_numpy(a) for a in (tables, hist, q))),
            *make_rope_table(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling))
    tl, th = tm.forward(*args, return_all_logits=True, return_hidden=True)
    valid = np.arange(T)[None] < q[:, None]
    np.testing.assert_allclose(tl.numpy()[valid], np.asarray(jl)[valid], rtol=0, atol=1e-5)
    np.testing.assert_allclose(th.numpy()[valid], np.asarray(jh)[valid], rtol=0, atol=1e-5)
    with pytest.raises(NotImplementedError, match='return_aux_hidden'):
        tm.forward(*args, return_all_logits=True, return_aux_hidden=True)


@pytest.mark.parametrize('name', ['ds', 'glm4', 'glm_dsa', 'v32'])
def test_head_step_and_loader_match_jax(ckpt, name):
    """Each head's tree exactly the reference loader's (and through params_from_jax),
    then two chained draft steps of three rows (the last inactive) over a cache of
    random stale pages at 1e-5: logits, features and the written rows.  Under the V3.2
    target the plain MLA head writes 32-wide rows into its own cache, where the
    reference's (the target's 48-wide rows, its 4 kv heads) reads the first 32."""
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.nn.layers import make_rope_table
    from lmdeploy_tpu_torch.weight_convert import params_from_jax
    jcls, tcls = mc.mtp_heads()[name]
    _, jtp = mc.jax_model(ckpt[name])
    _, ttp = mc.torch_model(ckpt[name])
    jh, jhp = mc.jax_model(ckpt[name], jcls)
    th, thp = mc.torch_model(ckpt[name], tcls)
    _tree_equal(thp, jhp)
    _tree_equal(params_from_jax(jhp), jhp)
    if name == 'v32':
        assert th.config.cache_head_dim == 48 and th.cache_width == 32
    cfg, B, BS, NB = th.config, 3, 16, 12
    rng = np.random.RandomState(1)
    rowp = kv_row_width(jh.config.num_key_value_heads, jh.config.cache_head_dim)[1]
    jcache = (rng.randn(1, NB, 2, BS, rowp) * 0.5).astype(np.float32)
    tcache = torch.from_numpy(jcache[..., :th.cache_width].copy())
    tables = (1 + np.arange(9, dtype=np.int32)).reshape(3, 3)
    pos = np.array([5, 30, 17], np.int32)
    q1 = np.array([1, 1, 0], np.int32)
    jfeat = jnp.asarray(rng.randn(B, cfg.hidden_size).astype(np.float32))
    tfeat = torch.from_numpy(np.array(jfeat))
    jcos, jsin = jrope(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling)
    tcos, tsin = make_rope_table(cfg.rope_dim, 256, cfg.rope_theta, cfg.rope_scaling)
    step = jax.jit(jh.step, static_argnames=('max_len',))
    for tok in (np.array([5, 77, 12], np.int32), np.array([9, 3, 12], np.int32)):
        jl, jfeat, jcache = step(jhp, jtp, jfeat, jnp.asarray(tok), jnp.asarray(pos),
                                 jnp.asarray(jcache), jnp.asarray(tables), jnp.asarray(q1),
                                 jcos, jsin, max_len=256)
        tl, tfeat = th.step(thp, ttp, tfeat, torch.from_numpy(tok), torch.from_numpy(pos),
                            tcache, torch.from_numpy(tables), torch.from_numpy(q1), tcos,
                            tsin, 256)
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], rtol=0, atol=1e-5)
        np.testing.assert_allclose(tfeat.numpy()[:2], np.asarray(jfeat)[:2], rtol=0,
                                   atol=1e-5)
        pos = pos + q1
    np.testing.assert_allclose(tcache.numpy(), np.asarray(jcache)[..., :th.cache_width],
                               rtol=0, atol=1e-5)


def test_blocked_fp8_head(tmp_path, monkeypatch):
    """A DeepSeek-V3 checkpoint in native blocked fp8, its MTP layer too: the reference
    loads the head's expert e4m3 codes without their scales (its plan has no scale
    entries), so the port refuses the head; with LMDEPLOY_TPU_FP8_DEQUANT=1 both
    dequantize every weight and the head loads as the reference's."""
    from lmdeploy_tpu.models.deepseek import DeepseekMTP as JD
    from lmdeploy_tpu_torch.models.mtp import DeepseekMTP
    path = mc.write_checkpoint(str(tmp_path / 'v3fp8'), 'v3', mtp=True, fp8=True)
    jh, jhp = mc.jax_model(path, JD)
    assert jh.moe_fp8 and np.abs(jhp['layer']['we_gate']).max() == 448.0   # raw codes
    with pytest.raises(NotImplementedError, match='ROADMAP.md section 3'):
        mc.torch_model(path, DeepseekMTP)
    with pytest.raises(NotImplementedError, match='weight_scale_inv'):
        sc.build('torch', path, SPEC)
    monkeypatch.setenv('LMDEPLOY_TPU_FP8_DEQUANT', '1')
    jh, jhp = mc.jax_model(path, JD)
    th, thp = mc.torch_model(path, DeepseekMTP)
    assert not th.moe_fp8 and np.abs(jhp['layer']['we_gate']).max() < 1.0
    _tree_equal(thp, jhp)


def test_eager_reason_weighs_the_heads_stacks(tmp_path):
    """A V3 target with blocked-fp8 experts (grouped GEMM from 768 rows) and its MTP
    head's dense seeded experts (from 128): at B = 128 the verify's 512 rows stay on the
    target's dense combine, the draft's 128 rows do not, and the step may not be
    captured, for the proposer's reason."""
    path = mc.write_checkpoint(str(tmp_path / 'v3fp8'), 'v3', mtp=True, fp8=True)
    engine = sc.build('torch', path, SPEC, empty_init=True)
    try:
        agent = engine.model_agent
        assert agent.spec.draft_ragged == 128
        assert agent._eager_reason(('spec', 'deepseek_mtp', 64), (), 768) is None
        why = agent._eager_reason(('spec', 'deepseek_mtp', 128), (), 768)
        assert why is not None and 'speculative proposer' in why
    finally:
        engine.close()


def test_a_target_with_its_own_forward_still_raises(ckpt, monkeypatch):
    """The verify runs through LlamaModel.forward or DeepseekV2Model.forward; a model
    class with a forward of its own is refused."""
    from lmdeploy_tpu_torch import models
    from lmdeploy_tpu_torch.models.deepseek import DeepseekV2Model

    class OwnForward(DeepseekV2Model):
        def forward(self, *args, **kwargs):
            return super().forward(*args, **kwargs)
    build = models._REGISTRY['DeepseekV2ForCausalLM']

    def own(config):
        build(config)
        return OwnForward(config)
    monkeypatch.setitem(models._REGISTRY, 'DeepseekV2ForCausalLM', own)
    with pytest.raises(NotImplementedError, match='runs its own'):
        sc.build('torch', ckpt['ds'], SPEC)
