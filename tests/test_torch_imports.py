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
assert len(names) >= 25, names
print(len(names))
'''
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
