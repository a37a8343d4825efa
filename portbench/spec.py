"""Where the harness finds a cell's parts, by the names in
``BENCHMARK.json``: nothing here names a cell, a configuration, a traffic
mix or a metric.

* ``portbench/configs/<config>.json``: the configuration as run;
* ``portbench/traffic/<traffic>.json``: the traffic mix's parameters;
* ``portbench/limits/<workload>.json``: the limits of the numbers the
  correctness check compares, with the readings they were set from;
* ``portbench/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(ctx)`` that returns the value or ``None`` where it finds
  nothing to read;
* ``portbench/reference/<reference>.py``: the plain reference model of a
  configuration, named by its file's ``"reference"`` (``detector`` where it
  names none; :func:`reference` lists what the module provides);
* ``portbench/scenes/<data.dataset>.py``: the cameras, ``ratio`` and ground
  truth of a dataset's scenes (``scenes/__init__.py``).

A cell reports its ``end_to_end`` metrics (those whose ``workloads`` list
holds it, or every one without the key) and the ``per_layer`` metrics that
list it, or, without ``workloads``, those that move an end-to-end metric
the cell reports.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_benchmark(path=None) -> dict:
    return _json(path or os.path.join(ROOT, 'BENCHMARK.json'))


def _reports(metric, cell_name, e2e_names=None):
    if 'workloads' in metric:
        return cell_name in metric['workloads']
    return e2e_names is None or metric['moves'] in e2e_names


def find_cell(name: str, bench: dict, base: str = HERE) -> Cell:
    """The cell ``name`` of ``bench`` with its files read from ``base``."""
    work = {w['name']: w for w in bench['workloads']}
    if name not in work:
        raise KeyError(f'no workload {name!r} in the benchmark '
                       f'(known: {sorted(work)})')
    w = work[name]
    e2e = [m for m in bench['end_to_end'] if _reports(m, name)]
    names = {m['name'] for m in e2e}
    layer = [m for m in bench['per_layer'] if _reports(m, name, names)]
    return Cell(
        name=name, chips=int(w['chips']),
        config=_json(os.path.join(base, 'configs', w['config'] + '.json')),
        traffic=_json(os.path.join(base, 'traffic', w['traffic'] + '.json')),
        limits=_json(os.path.join(base, 'limits', name + '.json')),
        end_to_end=e2e, per_layer=layer)


def reference(config: dict):
    """The reference module of the configuration file ``config``:
    ``reference/<config['reference']>.py``, ``detector`` where it names
    none.  It provides ``config_from_dict(model)`` (the reference's config
    of the file's ``model``), the model class ``ImVoxelNet(cfg)``
    (``forward(batch) -> (head_outs, valid)``, ``loss(head_outs, batch,
    valid)``), ``imvoxelnet_predict(cfg, head_outs, valid, origins)``,
    ``param_label(name)``, ``make_optimizer`` and ``make_train_step`` (the
    training check's), and ``init_overrides(model, serve)``, its entries of
    the weights' scheme on top of the generic one (``weights.py``)."""
    name = config.get('reference', 'detector')
    return importlib.import_module(f'{__package__}.reference.{name}')


def scenes(dataset: str):
    """The scenes module of ``dataset``: ``scenes/<dataset>.py``."""
    return importlib.import_module(f'{__package__}.scenes.{dataset}')


def reader(metric_name: str, base: str = HERE):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    path = os.path.join(base, 'metrics', metric_name + '.py')
    spec = importlib.util.spec_from_file_location(
        'portbench_metric_' + metric_name.replace('.', '_'), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
