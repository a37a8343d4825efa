"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` exports plain C functions; it is compiled for
``sm_90a`` into ``build/lib<name>-<hash>.so`` (the hash is of the source and
the flags, so an edited source is rebuilt) and opened with ``ctypes.CDLL``.
Building happens at first CUDA use, never at import, and only from the
sources in this package.  ``build_all()`` starts one nvcc per source at once
and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(_DIR, 'csrc')
BUILD_DIR = os.path.join(_DIR, 'build')

KERNELS = ('backproject', 'rect_clip', 'conv3x3x3')

_ARCH = ['-gencode=arch=compute_90a,code=sm_90a']
_FLAGS = ['-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
          '-Xptxas', '-v']
# B1 and B2 must pick the same pixel / produce the same bits as their plain
# versions, so no multiply-add contraction there.
_EXTRA = {'backproject': ['-fmad=false'], 'rect_clip': ['-fmad=false'],
          'conv3x3x3': []}

# Each library's functions and their ctypes argument types; every function
# returns the CUDA error code of its launch as an int, except those in
# RESTYPES.
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
SIGNATURES = {
    'backproject': {
        'imvx_backproject':
            [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _P],
        'imvx_backproject_grad':
            [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _L, _P],
        'imvx_backproject_grad_scratch': [_I, _I, _I, _I, _L]},
    'rect_clip': {
        'imvx_rect_clip': [_P, _P, _P, _L, _P],
        'imvx_rect_clip_grad': [_P, _P, _P, _P, _P, _P, _L, _P],
        'imvx_rect_clip_pairwise': [_P, _P, _P, _I, _I, _I, _P],
        'imvx_nms_mask': [_P, _P, _F, _P, _I, _I, _P],
        'imvx_nms_over': [_P, _P, _F, _P, _I, _I, _P],
        'imvx_nms_rank': [_P, _P, _P, _P, _I, _I, _P],
        'imvx_nms_scan': [_P, _P, _P, _I, _I, _P]},
    'conv3x3x3': {
        'imvx_conv3x3x3': [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]},
}
RESTYPES = {'imvx_backproject_grad_scratch': ctypes.c_longlong}

_lock = threading.Lock()
_loaded: dict = {}
build_seconds: dict = {}
ptxas_log: dict = {}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                          'bin', 'nvcc'), shutil.which('nvcc')]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError('nvcc not found: set CUDA_HOME or put nvcc on PATH')


def _command(name: str, out: str):
    return ([nvcc_path()] + _ARCH + _FLAGS + _EXTRA[name]
            + ['-o', out, os.path.join(SRC_DIR, f'{name}.cu')])


def _so_path(name: str) -> str:
    with open(os.path.join(SRC_DIR, f'{name}.cu'), 'rb') as f:
        digest = hashlib.sha256(f.read())
    digest.update(' '.join(_ARCH + _FLAGS + _EXTRA[name]).encode())
    return os.path.join(BUILD_DIR, f'lib{name}-{digest.hexdigest()[:12]}.so')


def sass_count(name: str, pattern: str) -> int:
    """How many lines of the built library's SASS (``cuobjdump -sass``)
    contain ``pattern``, e.g. ``HGMMA`` for tensor-core warpgroup MMAs."""
    kernel(name)
    tool = os.path.join(os.path.dirname(nvcc_path()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', _so_path(name)], check=True,
                          capture_output=True, text=True).stdout
    return sum(pattern in line for line in sass.splitlines())


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns the
    (process, tmp, so, t0) to finish, or None."""
    so = _so_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.tmp'
    proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, so, time.perf_counter()


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, so, t0 = job
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    ptxas_log[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed for {name}.cu '
                           f'(exit {proc.returncode}):\n{log}')
    os.replace(tmp, so)


def _open(name: str) -> dict:
    lib = ctypes.CDLL(_so_path(name))
    fns = {}
    for fn_name, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = RESTYPES.get(fn_name, ctypes.c_int)
        fns[fn_name] = fn
    return fns


def build_all(names=KERNELS) -> None:
    """Build every named kernel, all nvcc processes at once, and load them."""
    with _lock:
        names = [n for n in names if n not in _loaded]
        jobs = {n: _start(n) for n in names}
        errors = []
        for n in names:     # wait for every nvcc before raising
            try:
                _finish(n, jobs[n])
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError('\n'.join(errors))
        for n in names:
            _loaded[n] = _open(n)


def kernel(name: str, fn_name: str | None = None):
    """The ctypes entry point ``fn_name`` (``imvx_<name>`` unless given) of
    library ``name``, built on first use."""
    fns = _loaded.get(name)
    if fns is None:
        build_all((name,))
        fns = _loaded[name]
    return fns[fn_name or f'imvx_{name}']


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err}')
