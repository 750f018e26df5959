"""The port imports neither jax nor lmdeploy_tpu, in any of its modules."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_no_jax_or_reference_package():
    code = '''
import importlib, pkgutil, sys
import lmdeploy_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lmdeploy_tpu_torch.__path__,
                                               'lmdeploy_tpu_torch.')]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == 'jax' or m.startswith('jax.') or m == 'lmdeploy_tpu'
             or m.startswith('lmdeploy_tpu.'))
assert not bad, bad
assert len(names) >= 31, names
assert {'lmdeploy_tpu_torch.ops.moe', 'lmdeploy_tpu_torch.ops.quant_bmm',
        'lmdeploy_tpu_torch.parallel', 'lmdeploy_tpu_torch.parallel.mesh',
        'lmdeploy_tpu_torch.models.gpt_oss', 'lmdeploy_tpu_torch.ops.kv_quant',
        'lmdeploy_tpu_torch.ops.paged_decode', 'lmdeploy_tpu_torch.models.mixtral',
        'lmdeploy_tpu_torch.ops.quant_matmul', 'lmdeploy_tpu_torch.models.deepseek',
        'lmdeploy_tpu_torch.weight_loader'} <= set(names), names
from lmdeploy_tpu_torch.models.deepseek import DeepseekV2Model
from lmdeploy_tpu_torch.ops.quant_bmm import fp8_bmm, fp8_bmm_plain, widen_fp8
from lmdeploy_tpu_torch.ops.kv_quant import QuantKV4, QuantKVTurbo, to_fp8
from lmdeploy_tpu_torch.ops.paged_decode import (cp_combine, paged_decode_attention_cp,
                                                 paged_decode_cp_partial)
from lmdeploy_tpu_torch.parallel.mesh import StripedKV, build_mesh, cache_sharding
print(len(names))
'''
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_every_kernel_source_is_built():
    """``cuda_build.SOURCES`` names every ``csrc/*.cu`` (chip_smoke.py builds them all
    together) and each wrapper's library name is among them."""
    from lmdeploy_tpu_torch.ops import cuda_build
    on_disk = sorted(f[:-3] for f in os.listdir(cuda_build.CSRC_DIR) if f.endswith('.cu'))
    assert sorted(cuda_build.SOURCES) == on_disk
    assert {'mxfp4_bmm', 'paged_decode_int4', 'paged_decode_turbo', 'w4a16_gemm_szc',
            'w4a16_gemm_unprepared', 'fp8_bmm', 'paged_decode_cp'} <= set(on_disk)


def test_every_w4a16_wrapper_counts_and_has_a_plain_version():
    """The three W4A16 GEMMs (gd, fast / precise, unprepared) keep their own launch
    counts and plain versions, and the shared device header is part of each
    library's hash."""
    from lmdeploy_tpu_torch.ops import cuda_build
    from lmdeploy_tpu_torch.ops import quant_matmul as qm
    wrappers = (qm.w4a16_matmul_gd, qm.w4a16_matmul_szc, qm.w4a16_matmul)
    for wrapper in wrappers:
        assert isinstance(wrapper.launches, int)
        assert callable(getattr(qm, wrapper.__name__ + '_plain'))
    assert len({id(w) for w in wrappers}) == 3
    assert os.path.exists(os.path.join(cuda_build.CSRC_DIR, 'w4a16_gemm.cuh'))


def test_every_decode_wrapper_counts_and_has_a_plain_version():
    """Each cache type's decode wrapper keeps its own launch count and a plain
    version (the fp8 route's is the plain-layout one)."""
    from lmdeploy_tpu_torch.ops import paged_decode as pd
    for kind in ('', '_fp8', '_int8', '_int4', '_turbo'):
        wrapper = getattr(pd, 'paged_decode_attention' + kind)
        assert isinstance(wrapper.launches, int)
        assert callable(getattr(pd, f'paged_decode_attention{kind}_plain',
                                pd.paged_decode_attention_plain))
    assert len({id(getattr(pd, 'paged_decode_attention' + k)) for k in
                ('', '_fp8', '_int8', '_int4', '_turbo')}) == 5


def test_every_expert_bmm_wrapper_counts_and_has_a_plain_version():
    """The two expert-batched products (MXFP4, blocked fp8) keep their own launch
    counts and plain versions."""
    from lmdeploy_tpu_torch.ops import quant_bmm as qb
    for wrapper in (qb.mxfp4_bmm, qb.fp8_bmm):
        assert isinstance(wrapper.launches, int)
        assert callable(getattr(qb, wrapper.__name__ + '_plain'))
    assert qb.mxfp4_bmm is not qb.fp8_bmm
