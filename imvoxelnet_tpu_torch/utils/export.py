"""Ahead-of-time serving export: the forward + decode as a ``torch.export``
program.

Counterpart of ``imvoxelnet_tpu/utils/export.py`` (``serving_batch_spec``,
``make_serving_fn``, ``export_serving``, ``save_exported``,
``load_exported``).  The program is ``ImVoxelNet.forward`` (eval mode, no
gradient) plus ``imvoxelnet_predict``, the composition of
``apis.init_detector`` / ``eval/runner.py:forward``: decode and NMS inside
the graph, fixed-size outputs (``boxes (B, max_out, 7)``, ``scores``,
``labels``, ``valid``; a layout-head model serves on the extrinsics it
predicts and adds ``angles (B, 2)`` and ``layout (B, 7)``).

Two weight conventions, as in the JAX package:

* **weights as inputs** (the default): the program is
  ``(state_dict, batch) -> detections`` through
  ``torch.func.functional_call``, so the ``.pt2`` holds no weights; the
  caller passes the model's ``state_dict()`` (the reference's key names,
  as the ``OrderedDict`` that ``state_dict()`` and ``torch.load`` return).
* **weights baked** (``bake_variables=True``): ``batch -> detections``,
  the parameters and buffers stored in the ``.pt2``.

``batch_size=None`` exports with a symbolic batch dimension
(``torch.export.Dim``): one program serves any batch size.

The multi-device forms of the JAX ``export_serving`` (``platforms``,
``view_mesh``, ``data_mesh``):

* **platforms** (:func:`export_platforms`): one archive, one program per
  platform (``cuda``, ``cpu``) keyed by its name, each traced from inputs
  on its own device; the CPU program holds the kernels' plain versions.
  :func:`load_exported` picks the program of the current device.
* **view-sharded** (:func:`export_sharded` with ``'view'``): the program
  that every rank of a process group loads; its batch is the rank's view
  shard (``images (b, V/W, ...)``, ``extrinsics (b, V/W, 4, 4)``, the
  other entries whole), as the JAX artifact is called with arguments
  sharded over its view axis.  The backbone, FPN and backprojection run on
  the shard, the per-voxel (sum, count) pair is summed over the ranks by a
  traced ``_c10d_functional.all_reduce`` of the default group
  (``parallel/mesh.py:all_reduce_sum``), and the neck, head and decode run
  replicated: every rank returns the whole batch's detections.  The rank is
  not part of the program.
* **data-sharded** (``'data'``): the single-device program at ``b / W``,
  which every rank runs on its ``mesh.shard_batch`` slice; no collective,
  the outputs batch-sharded.

Every archive is one PT2 package of programs keyed by platform (a single
program by the platform it was traced on) and records ``devices`` (W),
``sharding`` and ``platforms`` beside them (:func:`load_meta`).

A program traced from CUDA inputs holds the port's kernels as the
operators ``torch.ops.imvx.*`` (``kernels/``: the backprojection, the
3x3x3 conv, the clip's pairwise and NMS-mask entries, the NMS scan), whose
CUDA implementations launch the hand-written kernels and count the
launches (``kernels.launch_counts``); one traced from CPU inputs holds the
kernels' plain versions.  Unlike the JAX package's self-describing
StableHLO, a ``.pt2`` with those operators runs only where they are
registered: :func:`load_exported` imports ``imvoxelnet_tpu_torch.kernels``
first, which registers them (and builds nothing until a launch).  Tensors
the program makes (anchors, voxel grids) are on the device it was traced
on: export on the device that will serve.  TF32 is a process flag, not
part of the program: run a float32 program inside
``utils/precision.compute_precision('float32')``.
"""

from __future__ import annotations

import collections
import copy
import json
import os
import zipfile

import numpy as np
import torch

from ..models.detector import imvoxelnet_predict
from ..parallel import mesh

# the platforms an archive may hold a program for
PLATFORMS = ('cuda', 'cpu')
# the archive's record of the devices and sharding of its programs
_META = 'imvoxelnet_meta.json'

# the batch entries of a serving program, in order
BATCH_KEYS = ('images', 'intrinsics', 'extrinsics', 'origins', 'img_shape',
              'ratios')


def serving_batch_spec(data_cfg, batch_size=1):
    """``{name: (shape, dtype)}`` of the inference batch at a preset's test
    geometry: images normalized and padded at ``test_size`` (float32; the
    model casts them to its compute dtype), one intrinsic per scene, an
    extrinsic per view, the grid origin, the valid ``(h, w)`` and the resize
    ratio.  ``batch_size=None`` puts ``None`` for the symbolic batch
    dimension."""
    w, h = data_cfg.test_size
    v = data_cfg.n_images_test
    b = batch_size
    f32, i32 = torch.float32, torch.int32
    return dict(images=((b, v, h, w, 3), f32), intrinsics=((b, 3, 3), f32),
                extrinsics=((b, v, 4, 4), f32), origins=((b, 3), f32),
                img_shape=((b, 2), i32), ratios=((b,), f32))


def example_batch(b: int, v: int, h: int, w: int, device='cuda',
                  seed: int = 0):
    """A synthetic ``b``-sample batch of ``v`` views of ``h x w`` (the JAX
    tool's ``__graft_entry__._kitti_batch``): random images, a 721.5 px
    focal length at the image center, identity extrinsics, the KITTI grid
    origin, ratio 1."""
    rng = np.random.RandomState(seed)
    k = np.array([[721.5, 0, w / 2], [0, 721.5, h / 2], [0, 0, 1]],
                 np.float32)
    batch = dict(
        images=rng.randn(b, v, h, w, 3).astype(np.float32),
        intrinsics=np.tile(k, (b, 1, 1)),
        extrinsics=np.tile(np.eye(4, dtype=np.float32), (b, v, 1, 1)),
        origins=np.tile(np.asarray([34.56, 0.0, -1.0], np.float32), (b, 1)),
        img_shape=np.tile(np.asarray([h, w], np.int32), (b, 1)),
        ratios=np.ones((b,), np.float32))
    return {k: torch.from_numpy(a).to(device) for k, a in batch.items()}


def output_shapes(exported):
    """``{name: shape}`` of a program's outputs; a symbolic size as its
    name."""
    out = next(n for n in exported.graph.nodes if n.op == 'output')
    vals = torch.utils._pytree.tree_unflatten(
        [a.meta['val'] for a in out.args[0]], exported.call_spec.out_spec)
    return {k: [d if isinstance(d, int) else str(d) for d in v.shape]
            for k, v in vals.items()}


def _serve(model_cfg, model, batch, state=None):
    """Forward (with ``state``'s weights, if given) and decode."""
    kwargs = {'use_predicted_extrinsics': model_cfg.layout_head is not None}
    if state is None:
        outs = model(batch, **kwargs)
    else:
        outs = torch.func.functional_call(model, state, (batch,), kwargs)
    head_outs, valid, *features_2d = outs
    return imvoxelnet_predict(model_cfg, head_outs, valid, batch['origins'],
                              *features_2d)


def make_serving_fn(model_cfg, model):
    """The ``(state_dict, batch) -> detections`` function that gets
    exported: ``model``'s forward with the given weights
    (``torch.func.functional_call``) and ``imvoxelnet_predict``; a
    layout-head model serves on its predicted extrinsics."""
    def forward(state, batch):
        return _serve(model_cfg, model, batch, state)

    return forward


class _WeightsAsInputs(torch.nn.Module):
    """``forward(state, batch)``; the model is held in a closure, not as a
    submodule, so that the program has no parameter of its own."""

    def __init__(self, model_cfg, model):
        super().__init__()
        self.fn = make_serving_fn(model_cfg, model)

    def forward(self, state, batch):
        return self.fn(state, batch)


class _Baked(torch.nn.Module):
    """``forward(batch)`` over the model's own parameters and buffers."""

    def __init__(self, model_cfg, model):
        super().__init__()
        self.cfg = model_cfg
        self.model = model

    def forward(self, batch):
        return _serve(self.cfg, self.model, batch)


def export_serving(model_cfg, model, batch, bake_variables: bool = False,
                   batch_size=1):
    """Export ``model``'s serving forward; returns a
    ``torch.export.ExportedProgram``.

    Args:
      model: the port's eval-mode ``ImVoxelNet`` on the device to serve on.
      batch: an example batch (``BATCH_KEYS``) on that device; its values
        do not matter, its shapes do (at least 2 samples for
        ``batch_size=None``).
      bake_variables: store the weights in the program; else it takes the
        ``state_dict`` as its first argument.
      batch_size: ``None`` for a symbolic batch dimension; else the batch
        size the program takes (``batch``'s).
    """
    batch = {k: batch[k] for k in BATCH_KEYS}
    dims = None
    if batch_size is None:
        if batch['images'].shape[0] < 2:
            raise ValueError('a batch-polymorphic export traces a batch of '
                             'at least 2 samples')
        b = torch.export.Dim('b', min=1, max=1024)
        dims = {k: {0: b} for k in BATCH_KEYS}
    elif batch['images'].shape[0] != batch_size:
        raise ValueError(f'the example batch holds '
                         f'{batch["images"].shape[0]} samples, not '
                         f'{batch_size}')
    model.eval()
    with torch.no_grad():
        # one call first: what the model builds once and caches (the
        # anchors) is then a constant of the program, on its device
        _serve(model_cfg, model, batch)
        if bake_variables:
            exported = torch.export.export(
                _Baked(model_cfg, model), (batch,),
                dynamic_shapes=None if dims is None else (dims,),
                strict=False)
        else:
            # traced with what state_dict() returns (an OrderedDict), the
            # program takes it as it comes, also from torch.load
            state = model.state_dict()
            exported = torch.export.export(
                _WeightsAsInputs(model_cfg, model), (state, batch),
                dynamic_shapes=None if dims is None else (
                    collections.OrderedDict((k, None) for k in state), dims),
                strict=False)
    # saved without the inputs it was traced with (the weights among them)
    exported.example_inputs = None
    return exported


def export_platforms(model_cfg, model, batch, platforms=PLATFORMS,
                     bake_variables: bool = False, batch_size=1):
    """``{platform: program}``: :func:`export_serving` once per platform,
    each traced from ``batch`` and a copy of ``model`` on that platform's
    device (the tensors a program makes live on the device it was traced
    on).  A CUDA program calls the kernels as ``torch.ops.imvx``
    operators, a CPU one holds their plain versions."""
    programs = {}
    for platform in platforms:
        if platform not in PLATFORMS:
            raise ValueError(f'platform {platform!r} is not one of '
                             f'{PLATFORMS}')
        device = torch.device(platform)
        here = next(model.parameters()).device.type == device.type
        programs[platform] = export_serving(
            model_cfg, model if here else copy.deepcopy(model).to(device),
            {k: v.to(device) for k, v in batch.items()}, bake_variables,
            batch_size)
    return programs


def export_sharded(model_cfg, model, batch, sharding: str,
                   bake_variables: bool = False):
    """The program of one rank of the default process group, and the
    rank's share of the global ``batch`` that it takes.

    ``sharding='view'``: ``model`` must be built with ``view_shard_axis``
    set; every rank traces the same program (the view pooling a traced
    all-reduce), so every rank must call this together.  ``'data'``: the
    unsharded program at the global batch over W."""
    if not mesh.is_distributed():
        raise ValueError('a sharded export runs in a process group '
                         '(parallel/mesh.py:init_distributed)')
    if sharding == 'view':
        if model.cfg.view_shard_axis is None:
            raise ValueError('a view-sharded export needs a model built '
                             'with view_shard_axis set')
        shard = mesh.shard_views(batch)
    elif sharding == 'data':
        shard = mesh.shard_batch(batch)
    else:
        raise ValueError(f'sharding {sharding!r} is not view or data')
    return export_serving(model_cfg, model, shard, bake_variables,
                          batch_size=shard['images'].shape[0]), shard


def traced_platform(exported) -> str:
    """The platform a program was traced on: ``cuda`` if one of the inputs
    its caller passes lay on the card, else ``cpu`` (the weights, buffers
    and constants it lifted are not asked: a constant may stay on the
    CPU)."""
    names = set(exported.graph_signature.user_inputs)
    devices = {node.meta['val'].device.type for node in exported.graph.nodes
               if node.op == 'placeholder' and node.name in names
               and isinstance(node.meta.get('val'), torch.Tensor)}
    return 'cuda' if 'cuda' in devices else 'cpu'


def save_exported(exported, path: str, devices: int = 1,
                  sharding=None) -> int:
    """Serialize one program (keyed by :func:`traced_platform`), or a
    ``{platform: program}`` dict, to ``path`` as one PT2 archive with the
    ``devices`` and ``sharding`` it was exported for; returns the byte
    size."""
    from torch.export.pt2_archive._package import package_pt2

    programs = (exported if isinstance(exported, dict)
                else {traced_platform(exported): exported})
    unknown = sorted(set(programs) - set(PLATFORMS))
    if unknown:
        raise ValueError(f'platforms {unknown} are not among {PLATFORMS}')
    meta = dict(devices=devices, sharding=sharding,
                platforms=sorted(programs))
    package_pt2(path, exported_programs=programs,
                extra_files={_META: json.dumps(meta)})
    return os.path.getsize(path)


def load_meta(path: str) -> dict:
    """The ``devices``, ``sharding`` and ``platforms`` an archive of
    :func:`save_exported` records, read from its zip directory without
    loading the programs."""
    with zipfile.ZipFile(path) as archive:
        names = [n for n in archive.namelist()
                 if n.endswith('/extra/' + _META)]
        if not names:
            raise ValueError(f'{path} is not an archive of save_exported '
                             f'(no {_META})')
        return json.loads(archive.read(names[0]))


def load_exported(path: str, platform=None):
    """Deserialize the program of ``platform`` (by default the current
    device's: ``cuda`` where a card is visible, else ``cpu``); run it as
    ``loaded.module()(batch)`` (baked) or
    ``loaded.module()(model.state_dict(), batch)``.  Raises ``KeyError`` if
    the archive holds no program for that platform.  Imports
    ``imvoxelnet_tpu_torch.kernels`` first: its modules register the
    ``torch.ops.imvx`` operators a CUDA program calls."""
    from torch.export.pt2_archive._package import load_pt2

    from .. import kernels  # noqa: F401  (registers torch.ops.imvx.*)

    programs = load_pt2(path).exported_programs
    platform = platform or ('cuda' if torch.cuda.is_available() else 'cpu')
    if platform not in programs:
        raise KeyError(f'{path} holds no program for {platform!r} (it '
                       f'holds {sorted(programs)})')
    return programs[platform]
