"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` (seconds to build, where a
source that includes PyTorch's headers takes minutes).  The build happens at first use
into ``lmdeploy_tpu_torch/_build/``, named by a hash of the source and the flags, so an
edited source rebuilds and an unchanged one is reused.  ``build()`` starts one ``nvcc``
per source, all together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, 'csrc')
BUILD_DIR = os.path.join(_PKG, '_build')
SOURCES = ('flash_prefill', 'paged_decode')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-lineinfo', '-Xptxas', '-v']

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels are built with the CUDA '
                           'toolkit on the machine that holds the GPU')
    return path


def lib_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, name + '.cu'), 'rb') as f:
        digest = hashlib.sha1(f.read() + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f'lib{name}-{digest[:12]}.so')


def log_path(name: str) -> str:
    return os.path.join(BUILD_DIR, name + '.log')


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, in parallel.

    Returns {name: build seconds} (0.0 for a library that was already built).
    Raises with the compiler's output when a source does not compile."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    seconds: Dict[str, float] = {}
    procs = {}
    for name in names:
        lib = lib_path(name)
        if os.path.exists(lib):
            seconds[name] = 0.0
            continue
        tmp = f'{lib}.{os.getpid()}.tmp'
        log = open(log_path(name), 'w')
        src = os.path.join(CSRC_DIR, name + '.cu')
        procs[name] = (subprocess.Popen([_nvcc(), *NVCC_FLAGS, '-o', tmp, src],
                                        stdout=log, stderr=subprocess.STDOUT),
                       tmp, lib, log, time.perf_counter())
    errors = []
    for name, (proc, tmp, lib, log, t0) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            with open(log_path(name)) as f:
                errors.append(f'nvcc failed on {name}.cu (exit {rc}):\n{f.read()}')
            continue
        os.replace(tmp, lib)
    if errors:
        raise RuntimeError('\n'.join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build([name])
                lib = ctypes.CDLL(lib_path(name))
                _libs[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes):
    """C entry point ``symbol`` of ``csrc/<name>.cu`` with its argument types
    declared (pointers as ``c_void_p``, so ctypes never truncates them) and an
    ``int`` CUDA error code as the result."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def stream_handle(t) -> int:
    """The raw CUDA stream PyTorch launches on for ``t``'s device."""
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, kernel: str):
    if rc != 0:
        raise RuntimeError(f'{kernel} kernel launch failed with CUDA error {rc}')
