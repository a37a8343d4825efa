"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port.  Top-level module names are
compared whole: ``imvoxelnet_tpu_torch`` begins with ``imvoxelnet_tpu``."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from portbench import harness, spec

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'optax', 'imvoxelnet_tpu'}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0]


def _sources(*parts):
    return glob.glob(os.path.join(spec.HERE, *parts, '*.py'))


def test_no_module_imports_jax_or_the_jax_package():
    files = (_sources() + _sources('reference') + _sources('scenes')
             + _sources('metrics') + _sources('tests')
             + _sources('tests', 'new_config'))
    assert files
    for path in files:
        assert not set(_imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    """Every reference and scenes module, the new configuration's test
    modules too: by their import lines, and loaded in a fresh process."""
    files = (_sources('reference') + _sources('scenes')
             + _sources('tests', 'new_config'))
    for path in files:
        assert 'imvoxelnet_tpu_torch' not in set(_imports(path)), path
    modules = [f'portbench.{sub}.{os.path.basename(p)[:-3]}'
               for sub in ('reference', 'scenes') for p in _sources(sub)]
    code = ('import importlib, sys\n'
            f'for m in {modules!r}: importlib.import_module(m)\n'
            'sys.exit(sorted(m for m in sys.modules if m.split(".")[0] in '
            '("imvoxelnet_tpu_torch", "imvoxelnet_tpu", "jax")) != [])')
    subprocess.run([sys.executable, '-c', code], cwd=spec.ROOT, check=True)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, 'imvoxelnet_tpu_torch_x', sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, 'jaxlib', sys)
    assert harness.forbidden_modules() == ['jaxlib']


def test_run_without_a_card_prints_no_result():
    proc = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload',
         'kitti-serve-b8', '--seed', str(2 ** 31 + 5), '--seconds', '1',
         '--trace', '0'], cwd=spec.ROOT, capture_output=True, text=True)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout


def test_run_needs_the_port(tmp_path):
    """In a directory that holds only BENCHMARK.json and portbench/, a run
    fails and prints no result."""
    import shutil
    shutil.copy(os.path.join(spec.ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    proc = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload',
         'kitti-serve-b8', '--seed', '3', '--seconds', '1', '--trace', '0'],
        cwd=tmp_path, capture_output=True, text=True)
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
