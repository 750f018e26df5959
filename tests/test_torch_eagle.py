"""The port's speculative-decoding model pieces against the JAX package (CPU, f32).

``LlamaModel.forward``'s ``return_hidden`` / ``return_aux_hidden`` features, both EAGLE
heads' ``step`` (and EAGLE-3's ``fc`` conditioning) on the same numpy parameters carried
over by ``params_from_jax``, the heads' loaders leaf for leaf against the reference's
``load_params_np``, and the heads' configs.  Tolerance: 1e-5 (f32) on every float.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spec_cases as sc

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def heads(tmp_path_factory):
    root = tmp_path_factory.mktemp('heads')
    return {'eagle': sc.write_eagle(root / 'eagle'), 'eagle3': sc.write_eagle3(root / 'eagle3'),
            'eagle3_no_embed': sc.write_eagle3(root / 'eagle3_ne', embed=False)}


@pytest.fixture(scope='module')
def target(tiny_model_dir):
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models import build_model as jbuild
    from lmdeploy_tpu.weight_loader import load_model_params
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models import build_model as tbuild
    from lmdeploy_tpu_torch.weight_convert import params_from_jax
    jm = jbuild(JConfig.from_pretrained(tiny_model_dir))
    tm = tbuild(TConfig.from_pretrained(tiny_model_dir))
    jp = load_model_params(jm, tiny_model_dir)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    return jm, jp, tm, tp


def _head_pair(kind, path):
    """(JAX head, its params, port head, port params through params_from_jax)."""
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models.eagle import Eagle3Head as J3, EagleHead as J1
    from lmdeploy_tpu.weight_loader import load_model_params
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models.eagle import Eagle3Head as T3, EagleHead as T1
    from lmdeploy_tpu_torch.weight_convert import params_from_jax
    jcls, tcls = (J3, T3) if kind.startswith('eagle3') else (J1, T1)
    jh, th = jcls(JConfig.from_pretrained(path)), tcls(TConfig.from_pretrained(path))
    jp = load_model_params(jh, path)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
    if hasattr(jh, 'saw_embed'):
        th.saw_embed = jh.saw_embed       # the port's loader sets it (tested above)
    return jh, jp, th, tp


@pytest.mark.parametrize('kind', ['eagle', 'eagle3', 'eagle3_no_embed'])
def test_head_loader_matches_reference(heads, kind):
    """Both head layouts load leaf for leaf as the reference's loader reads them (and
    params_from_jax carries the same tree, d2t as int32 ids)."""
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu.models.eagle import Eagle3Head as J3, EagleHead as J1
    from lmdeploy_tpu.weight_loader import load_params_np
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    from lmdeploy_tpu_torch.models.eagle import Eagle3Head as T3, EagleHead as T1
    from lmdeploy_tpu_torch.weight_loader import load_params
    path = heads[kind]
    jcls, tcls = (J3, T3) if kind.startswith('eagle3') else (J1, T1)
    jh, th = jcls(JConfig.from_pretrained(path)), tcls(TConfig.from_pretrained(path))
    ref = load_params_np(jh, path)
    got = load_params(th, path, 'cpu')
    assert set(got) == set(ref)
    for name, leaf in ref.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(leaf), err_msg=name)
    if kind.startswith('eagle3'):
        assert got['d2t'].dtype == torch.int32
        assert th.saw_embed == jh.saw_embed == (kind == 'eagle3')
        assert th.draft_vocab == jh.draft_vocab == sc.DV
        assert th.target_hidden == jh.target_hidden == sc.H
    conv = _head_pair(kind, path)[3]
    for name, leaf in got.items():
        assert conv[name].dtype == leaf.dtype and torch.equal(conv[name], leaf), name


def test_head_config_matches_reference(heads):
    """An EAGLE-3 config (LlamaForCausalLMEagle3, draft_vocab_size, target_hidden_size)
    parses to the reference's fields."""
    from lmdeploy_tpu.config import ModelConfig as JConfig
    from lmdeploy_tpu_torch.config import ModelConfig as TConfig
    for path in heads.values():
        j, t = JConfig.from_pretrained(path), TConfig.from_pretrained(path)
        for f in ('num_layers', 'num_attention_heads', 'num_key_value_heads', 'hidden_size',
                  'intermediate_size', 'vocab_size', 'head_dim', 'rope_theta',
                  'rms_norm_eps', 'hf_arch', 'tie_word_embeddings'):
            assert getattr(t, f) == getattr(j, f), f
        assert t.hf_config.get('draft_vocab_size') == j.hf_config.get('draft_vocab_size')


@pytest.mark.parametrize('return_all', [True, False])
def test_forward_features_match_jax(target, return_all):
    """The pre-final-norm hidden (EAGLE) and the concatenated layer outputs (EAGLE-3),
    at a fresh prefill chunk and a continuation chunk."""
    from lmdeploy_tpu.models.llama import AttnMeta as JMeta
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.models.llama import AttnMeta as TMeta
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference
    jm, jp, tm, tp = target
    cfg = jm.config
    taps = (1, 0, 0)                    # spec_agent's clip of (1, L/2 - 1, L - 4) at L = 2
    jm.aux_hidden_layers = tm.aux_hidden_layers = taps
    _, hdp = kv_row_width(cfg.num_key_value_heads, cfg.head_dim)
    jcos, jsin = jrope(cfg.head_dim, 256, cfg.rope_theta)
    tcos, tsin = trope(cfg.head_dim, 256, cfg.rope_theta)
    tables = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    ids = np.random.RandomState(3).randint(3, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    jcache = jnp.zeros((cfg.num_layers, 8, 2, 16, hdp), jnp.float32)
    tcache = cache_from_reference(np.asarray(jcache), cfg.num_key_value_heads, cfg.head_dim)
    for hist, qlen, T, fresh in (((0, 0), (19, 11), 19, True), ((19, 11), (5, 5), 5, False)):
        hist, qlen = np.array(hist, np.int32), np.array(qlen, np.int32)
        x = np.zeros((2, T), np.int32)
        pos = np.zeros((2, T), np.int32)
        for b in range(2):
            x[b, :qlen[b]] = ids[b, hist[b]:hist[b] + qlen[b]]
            pos[b, :qlen[b]] = np.arange(hist[b], hist[b] + qlen[b])
        jmeta = JMeta(jnp.asarray(tables), jnp.asarray(hist), jnp.asarray(qlen))
        tmeta = TMeta(torch.from_numpy(tables), torch.from_numpy(hist), torch.from_numpy(qlen))
        args = (torch.from_numpy(x), torch.from_numpy(pos))
        for kw in (dict(return_hidden=True), dict(return_aux_hidden=True)):
            if 'return_aux_hidden' in kw and not return_all:
                continue
            jl, _, jf = jm.forward(jp, jnp.asarray(x), jnp.asarray(pos), jcache, jmeta, jcos,
                                   jsin, return_all_logits=return_all, fresh_prefill=fresh,
                                   **kw)
            tl, tf = tm.forward(tp, *args, tcache.clone(), tmeta, tcos, tsin,
                                return_all_logits=return_all, fresh_prefill=fresh, **kw)
            jl, jf = np.asarray(jl), np.asarray(jf)
            if return_all:
                for b in range(2):
                    np.testing.assert_allclose(tl[b, :qlen[b]].numpy(), jl[b, :qlen[b]], **TOL)
                    np.testing.assert_allclose(tf[b, :qlen[b]].numpy(), jf[b, :qlen[b]], **TOL)
            else:
                np.testing.assert_allclose(tl.numpy(), jl, **TOL)
                np.testing.assert_allclose(tf.numpy(), jf, **TOL)
            if 'return_aux_hidden' in kw:
                assert tf.shape[-1] == 3 * cfg.hidden_size
        # advance both caches through the chunk
        _, jcache = jm.forward(jp, jnp.asarray(x), jnp.asarray(pos), jcache, jmeta, jcos, jsin,
                               fresh_prefill=fresh)
        tm.forward(tp, *args, tcache, tmeta, tcos, tsin, fresh_prefill=fresh)


@pytest.mark.parametrize('kind', ['eagle', 'eagle3', 'eagle3_no_embed'])
def test_head_step_matches_jax(target, heads, kind):
    """Three chained draft steps of a head over its own one-layer cache (random stale
    slots before the rows' positions) give the reference's logits, features and cache."""
    from lmdeploy_tpu.nn.layers import make_rope_table as jrope
    from lmdeploy_tpu.ops.attention import kv_row_width
    from lmdeploy_tpu_torch.nn.layers import make_rope_table as trope
    from lmdeploy_tpu_torch.weight_convert import cache_from_reference, cache_to_reference
    jm, jtp, tm, ttp = target
    jh, jp, th, tp = _head_pair(kind, heads[kind])
    cfg = jh.config
    B, NB, BS = 3, 10, 16
    rng = np.random.RandomState(11)
    tables = np.array([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    _, hdp = kv_row_width(cfg.num_key_value_heads, cfg.head_dim)
    hd = cfg.num_key_value_heads * cfg.head_dim
    cache = np.zeros((1, NB, 2, BS, hdp), np.float32)
    cache[..., :hd] = rng.randn(1, NB, 2, BS, hd) * 0.5
    jcache = jnp.asarray(cache)
    tcache = cache_from_reference(cache, cfg.num_key_value_heads, cfg.head_dim)
    jcos, jsin = jrope(jm.config.head_dim, 256, jm.config.rope_theta)
    tcos, tsin = trope(jm.config.head_dim, 256, jm.config.rope_theta)
    eagle3 = kind.startswith('eagle3')
    width = 3 * th.target_hidden if eagle3 else jm.config.hidden_size
    feat = rng.randn(B, width).astype(np.float32)
    pos = np.array([5, 17, 40], np.int32)
    qlen = np.array([1, 1, 0], np.int32)          # the last row inactive
    tok = rng.randint(3, 250, size=B).astype(np.int32)
    if eagle3:
        jemb = jp['embed'] if jh.saw_embed else jtp['embed']
        temb = tp['embed'] if th.saw_embed else ttp['embed']
        jh_c = (jnp.asarray(feat) @ jp['fc'].astype(jnp.float32)).astype(jemb.dtype)
        th_c = th.condition(tp, torch.from_numpy(feat), temb.dtype)
        np.testing.assert_allclose(th_c.numpy(), np.asarray(jh_c), **TOL)
        jt, tt = jemb, temb
    else:
        jh_c, th_c, jt, tt = jnp.asarray(feat), torch.from_numpy(feat), jtp, ttp
    for _ in range(3):
        jl, jh_c, jcache = jh.step(jp, jt, jh_c, jnp.asarray(tok), jnp.asarray(pos), jcache,
                                   jnp.asarray(tables), jnp.asarray(qlen), jcos, jsin, 256)
        tl, th_c = th.step(tp, tt, th_c, torch.from_numpy(tok), torch.from_numpy(pos), tcache,
                           torch.from_numpy(tables), torch.from_numpy(qlen), tcos, tsin, 256)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(th_c.numpy(), np.asarray(jh_c), **TOL)
        assert tl.shape[-1] == (sc.DV if eagle3 else sc.V)
        tok = np.asarray(jl).argmax(-1).astype(np.int32)
        pos = pos + qlen
    np.testing.assert_allclose(cache_to_reference(tcache)[:, 1:], np.asarray(jcache)[:, 1:],
                               **TOL)
