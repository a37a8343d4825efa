"""The PyTorch port as a package: import isolation, presets, weight bridge."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.utils.checkpoint import convert_reference_checkpoint

from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.models.detector import ImVoxelNet
from imvoxelnet_tpu_torch.utils.checkpoint import from_jax_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PRESET_NAMES = ('imvoxelnet_kitti', 'tiny_kitti_test', 'imvoxelnet_sunrgbd',
                'imvoxelnet_sunrgbd_top27', 'imvoxelnet_sunrgbd_fast',
                'imvoxelnet_perspective_sunrgbd',
                'imvoxelnet_perspective_sunrgbd_top27',
                'imvoxelnet_perspective_sunrgbd_fast',
                'imvoxelnet_total_sunrgbd', 'imvoxelnet_total_sunrgbd_top27',
                'imvoxelnet_total_sunrgbd_fast', 'imvoxelnet_scannet',
                'imvoxelnet_scannet_top27', 'imvoxelnet_scannet_fast',
                'imvoxelnet_nuscenes')


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """A tiny forward + decode, a training step, a tiny SUN RGB-D forward
    + decode, a tiny Total3D one (predicted extrinsics), a tiny 3-view
    ScanNet one, a tiny six-view nuScenes one (DCN backbone) and a tiny
    KITTI val split (PNG files) through ``build_val_dataset`` ->
    ``run_inference`` -> ``evaluate_results``, with ``apis``,
    ``tools.train`` and ``tools.validate_learning`` imported, in a fresh
    interpreter leave
    every ``jax*``, ``flax*``, ``optax*``, ``ml_dtypes`` and ``cv2``
    module and every
    ``imvoxelnet_tpu``/``imvoxelnet_tpu.*`` module out of ``sys.modules``
    (``imvoxelnet_tpu_torch`` shares the prefix, hence the exact-name
    test)."""
    code = textwrap.dedent('''
        import sys
        import numpy as np
        import torch
        import imvoxelnet_tpu_torch
        # the training CLI, the API and the learning loops
        from imvoxelnet_tpu_torch import apis
        from imvoxelnet_tpu_torch.tools import train, validate_learning
        from imvoxelnet_tpu_torch.configs.presets import get_preset
        from imvoxelnet_tpu_torch.models.detector import (
            build_model, imvoxelnet_predict)
        cfg = get_preset('tiny_kitti_test').model
        model = build_model(cfg, device='cpu', seed=0)
        b, h, w = 1, 96, 320
        k = torch.tensor([[180., 0, 160.], [0, 180., 48.], [0, 0, 1]])
        ext = torch.tensor([[0., -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0],
                            [0, 0, 0, 1]])
        batch = dict(images=torch.randn(b, 1, h, w, 3),
                     intrinsics=k[None], extrinsics=ext[None, None],
                     origins=torch.tensor([[12.8, 0.0, -1.0]]),
                     img_shape=torch.tensor([[h, w]], dtype=torch.int32),
                     ratios=torch.full((b,), 4.0))
        with torch.no_grad():
            head_outs, valid = model(batch)
            res = imvoxelnet_predict(cfg, head_outs)
        assert res['boxes'].shape == (1, cfg.anchor_head.max_out, 7)
        # and one training step: targets, losses, backward, optimizer
        from imvoxelnet_tpu_torch.parallel import train
        from imvoxelnet_tpu_torch.utils import synthetic
        gt = synthetic.car_boxes(np.random.RandomState(0), b, 8,
                                 (3.0, 23.0), (-0.5, 0.5), (-11.0, 11.0))
        batch.update(gt_boxes=torch.from_numpy(gt[0]),
                     gt_labels=torch.from_numpy(gt[1]),
                     gt_mask=torch.from_numpy(gt[2]))
        opt, sched = train.make_optimizer(model, 1e-4, 1e-4, 0.1, 35.0,
                                          steps_per_epoch=1)
        metrics = train.make_train_step(model, opt, sched)(batch)
        assert torch.isfinite(metrics['loss'])
        # and a tiny SUN RGB-D forward + decode (encoder-decoder neck)
        import dataclasses
        from imvoxelnet_tpu_torch.models.detector import NeckConfig
        full = get_preset('imvoxelnet_sunrgbd').model
        icfg = dataclasses.replace(
            full, n_voxels=(16, 16, 8), voxel_size=(0.4, 0.4, 0.4),
            fpn_out_channels=16, backbone_stage_blocks=(1, 1, 1, 1),
            neck=NeckConfig(kind='imvoxel', channels=(16, 24, 32, 48),
                            out_channels=16, down_layers=(1, 1, 1, 1),
                            up_layers=(1, 1, 1)),
            indoor_head=dataclasses.replace(
                full.indoor_head, voxel_size=(0.4, 0.4, 0.4), nms_pre=64,
                pre_nms_k=32, max_out=16))
        imodel = build_model(icfg, device='cpu', seed=0)
        ibatch = synthetic.sunrgbd_batch(1, 'cpu', seed=0, size=(128, 96))
        with torch.no_grad():
            ihead, ivalid = imodel(ibatch)
            ires = imvoxelnet_predict(icfg, ihead, ivalid, ibatch['origins'])
        assert ires['boxes'].shape == (1, 16, 7)
        assert 0 < float(ivalid.float().mean()) < 1
        # and tiny Total3D (layout head, predicted extrinsics) and 3-view
        # ScanNet forwards + decodes
        for name, views in (('imvoxelnet_total_sunrgbd', 1),
                            ('imvoxelnet_scannet', 3)):
            full = get_preset(name).model
            tcfg = dataclasses.replace(
                icfg, layout_head=full.layout_head,
                indoor_head=dataclasses.replace(
                    icfg.indoor_head,
                    dataset=full.indoor_head.dataset,
                    n_reg_outs=full.indoor_head.n_reg_outs,
                    n_classes=full.indoor_head.n_classes))
            tmodel = build_model(tcfg, device='cpu', seed=0)
            if views == 1:
                tbatch = synthetic.sunrgbd_batch(1, 'cpu', seed=0,
                                                 size=(128, 96))
            else:
                tbatch = synthetic.scannet_batch(1, views, 'cpu', seed=0,
                                                 size=(128, 96))
            with torch.no_grad():
                outs = tmodel(tbatch, use_predicted_extrinsics=True)
                tres = imvoxelnet_predict(tcfg, outs[0], outs[1],
                                          tbatch['origins'], *outs[2:])
            assert len(outs) == (3 if views == 1 else 2)
            assert tres['boxes'].shape == (1, 16, 7)
            assert ('layout' in tres) == (views == 1)
        # and a tiny six-view nuScenes forward + decode (DCN in stages 3-4,
        # the nuScenes neck)
        full = get_preset('imvoxelnet_nuscenes').model
        ncfg = dataclasses.replace(
            full, n_voxels=(16, 16, 12), voxel_size=(1.6, 1.6, 0.32),
            fpn_out_channels=16, backbone_stage_blocks=(1, 1, 1, 1),
            neck=dataclasses.replace(full.neck, in_channels=16,
                                     out_channels=32),
            anchor_head=dataclasses.replace(
                full.anchor_head,
                anchor_ranges=((-12.8, -12.8, -1.0, 9.6, 9.6, -1.0),),
                nms_pre=64, max_out=16))
        nmodel = build_model(ncfg, device='cpu', seed=0)
        nbatch = synthetic.nuscenes_batch(1, 'cpu', seed=0, size=(96, 64))
        with torch.no_grad():
            nhead, nvalid = nmodel(nbatch)
            nres = imvoxelnet_predict(ncfg, nhead)
        assert nhead[0].shape == (1, 8, 8, 2)
        assert nres['boxes'].shape == (1, 16, 7)
        assert 0 < float(nvalid.float().mean()) < 1
        # and the evaluation path: a tiny KITTI val split written as PNG
        # files, read, served and scored
        import tempfile
        from imvoxelnet_tpu_torch.configs.presets import get_preset
        from imvoxelnet_tpu_torch.eval import runner
        from imvoxelnet_tpu_torch.utils.synthetic_splits import kitti_split
        with tempfile.TemporaryDirectory() as root:
            ann = kitti_split(root, 2, seed=0, frame_hw=(94, 310))
            preset = get_preset('tiny_kitti_test')
            dataset, loader = runner.build_val_dataset(
                preset, 'tiny_kitti_test', root, ann, num_workers=2,
                batch_size=2, device='cpu')
            results = runner.run_inference(model, preset.model, loader, 2,
                                           device='cpu')
            metrics = runner.evaluate_results(preset, 'tiny_kitti_test',
                                              dataset, results,
                                              device='cpu')
        assert len(results) == 2 and 'KITTI/Car_3D_moderate' in metrics
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0].startswith(('jax', 'flax', 'optax',
                                                    'ml_dtypes', 'cv2'))
                     or m == 'imvoxelnet_tpu'
                     or m.startswith('imvoxelnet_tpu.'))
        print('LOADED', bad)
        sys.exit(1 if bad else 0)
    ''')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


# JAX config fields the port leaves to later slices, with the values every
# ported preset must hold for them.
_JAX_ONLY = {
    'ImVoxelNetConfig': dict(axis_name=None, view_shard_axis=None),
}


def _assert_same(port, ref, path):
    if not dataclasses.is_dataclass(port):
        assert port == ref, (path, port, ref)
        return
    assert type(port).__name__ == type(ref).__name__, path
    port_fields = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        if f.name in port_fields:
            _assert_same(getattr(port, f.name), getattr(ref, f.name),
                         f'{path}.{f.name}')
            continue
        only = _JAX_ONLY.get(type(ref).__name__, {})
        assert f.name in only, f'{path}.{f.name} missing from the port'
        if only[f.name] is not None:
            assert getattr(ref, f.name) == only[f.name], (path, f.name)
    assert port_fields <= {f.name for f in dataclasses.fields(ref)}, path


@pytest.mark.parametrize('name', PRESET_NAMES)
def test_preset_equals_jax_field_for_field(name):
    port, ref = presets.get_preset(name), jax_presets.get_preset(name)
    _assert_same(port, ref, name)
    if port.model.head_kind == 'anchor3d':
        assert port.model.anchor_head.num_anchors == \
            ref.model.anchor_head.num_anchors
        assert port.model.anchor_head.box_code_size == \
            ref.model.anchor_head.box_code_size
    else:
        assert port.model.indoor_head.with_yaw == \
            ref.model.indoor_head.with_yaw


def _randomize_bn(model, rng):
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith(('running_mean', 'bias')):
                t.copy_(torch.from_numpy(
                    rng.randn(*t.shape).astype(np.float32) * 0.1))
            elif name.endswith('running_var') or (
                    name.endswith('weight') and t.dim() == 1):
                t.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, t.shape).astype(np.float32)))


# each model family once: the perspective presets differ only in classes,
# the Total3D ones from the votenet ones in the layout head
@pytest.mark.parametrize('name', PRESET_NAMES[:5] + (
    'imvoxelnet_total_sunrgbd', 'imvoxelnet_scannet',
    'imvoxelnet_scannet_fast', 'imvoxelnet_nuscenes'))
def test_state_dict_round_trip_through_the_jax_converter(name):
    """port state_dict -> convert_reference_checkpoint(strict) ->
    from_jax_variables gives the same state_dict back, key for key."""
    cfg = presets.get_preset(name).model
    jcfg = jax_presets.get_preset(name).model
    model = ImVoxelNet(cfg)
    _randomize_bn(model, np.random.RandomState(0))
    sd = model.state_dict()
    variables = convert_reference_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, jcfg, strict=True)
    back = from_jax_variables(variables, cfg)
    assert set(back) == set(sd)
    for key, val in sd.items():
        assert back[key].dtype == val.dtype, key
        assert torch.equal(back[key], val), key


def test_native_libraries_raise_without_a_compiler(tmp_path, monkeypatch):
    """No fallback: where a host library cannot be built (the compiler is
    missing), the call raises, naming the compiler, and leaves no file."""
    from imvoxelnet_tpu_torch import native
    from imvoxelnet_tpu_torch.data import pipeline

    monkeypatch.setattr(native, 'CXX', str(tmp_path / 'no-such-g++'))
    monkeypatch.setattr(native, 'BUILD_DIR', str(tmp_path / 'build'))
    monkeypatch.setattr(native, '_loaded', {})
    with pytest.raises(RuntimeError, match='no-such-g\\+\\+'):
        pipeline.process_image(np.zeros((4, 4, 3), np.uint8),
                               pipeline.ImagePipelineConfig(
                                   test_scale=(4, 4), pad_size=(4, 4)),
                               False, np.random.RandomState(0))
    with pytest.raises(RuntimeError, match='no-such-g\\+\\+'):
        native.compute_statistics_thresholds(
            np.zeros((1, 1)), np.zeros(1), np.zeros(1), np.zeros(1),
            np.zeros(1), np.zeros(1), np.zeros((1, 0)), 0.5, np.zeros(1), 0,
            np.zeros((1, 4)))
    assert os.listdir(tmp_path / 'build') == []


def test_state_dict_keys_are_the_reference_manifest():
    """The port's names are the released checkpoint's mmdet names."""
    from test_full_detector_parity import expected_kitti_state_dict_keys
    cfg = presets.get_preset('imvoxelnet_kitti').model
    assert set(ImVoxelNet(cfg).state_dict()) == set(
        expected_kitti_state_dict_keys())


def test_every_port_module_imports_without_jax_or_cv2():
    """Every module of the port, the tools and the export, visualization
    and fold modules, the converters, the data-parallel modules and the
    measurement tools included, imported in a fresh interpreter, starts no
    process group and leaves
    every ``jax*``, ``flax*``, ``optax*``, ``ml_dtypes`` and ``cv2`` module
    and every ``imvoxelnet_tpu``/``imvoxelnet_tpu.*`` module out of
    ``sys.modules`` (``utils/visualize.py`` imports cv2 only to draw)."""
    code = textwrap.dedent('''
        import importlib, pkgutil, sys
        import imvoxelnet_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            imvoxelnet_tpu_torch.__path__, 'imvoxelnet_tpu_torch.')]
        for name in names:
            importlib.import_module(name)
        need = {'imvoxelnet_tpu_torch.' + n for n in (
            'utils.export', 'utils.visualize', 'utils.fuse',
            'core.box_modes', 'tools.export', 'tools.demo',
            'tools.fuse_conv_bn', 'tools.publish_model',
            'tools.print_config', 'data.converters.kitti_converter',
            'data.converters.sunrgbd_converter',
            'data.converters.sunrgbd_total_converter',
            'data.converters.scannet_converter',
            'data.converters.nuscenes_converter', 'tools.create_data',
            'parallel.mesh', 'tools.validate_multihost',
            'utils.synthetic_raw', 'tools.benchmark', 'tools.analyze_trace',
            'tools.analyze_logs', 'tools.flops', 'tools.bench_conv3z',
            'tools.bench_iou_kernel', 'tools.bench_scatter',
            'tools.bench_loader', 'tools.eval_nms_truncation',
            'tools.make_synthetic_kitti', 'tools.microbench')}
        assert need <= set(names), need - set(names)
        # no process group is started by an import
        import torch.distributed as dist
        assert not dist.is_initialized()
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0].startswith(('jax', 'flax', 'optax',
                                                    'ml_dtypes', 'cv2'))
                     or m == 'imvoxelnet_tpu'
                     or m.startswith('imvoxelnet_tpu.'))
        print('MODULES', len(names), 'LOADED', bad)
        sys.exit(1 if bad else 0)
    ''')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_load_exported_in_a_fresh_interpreter_registers_the_kernels(
        tmp_path):
    """A serving program's loader alone: a fresh interpreter that imports
    ``imvoxelnet_tpu_torch.utils.export`` and nothing else of the port
    loads a saved program with ``load_exported``, which registers the
    ``torch.ops.imvx`` operators (a CUDA program calls them), and imports
    no JAX.  Without the registration an ``imvx`` operator does not
    exist; on a CPU tensor a registered one raises (no CPU kernel, no
    fallback)."""
    from imvoxelnet_tpu_torch.utils import export as export_lib

    class Tiny(torch.nn.Module):
        def forward(self, x):
            return {'y': x * 2}

    path = str(tmp_path / 'tiny.pt2')
    export_lib.save_exported(torch.export.export(Tiny(), (torch.ones(3),)),
                             path)
    code = textwrap.dedent(f'''
        import sys
        import torch
        assert not hasattr(torch.ops.imvx, 'backproject')
        from imvoxelnet_tpu_torch.utils import export
        program = export.load_exported({path!r}).module()
        assert torch.equal(program(torch.ones(3))['y'], torch.full((3,), 2.))
        names = [op for op in ('backproject', 'conv3x3x3',
                               'rect_clip_pairwise', 'nms_mask', 'nms_over',
                               'nms_rank', 'nms_scan')
                 if hasattr(torch.ops.imvx, op)]
        assert len(names) == 7, names
        try:
            torch.ops.imvx.nms_scan(torch.zeros(1, 3, 1, dtype=torch.int32),
                                    torch.ones(1, 3, dtype=torch.bool))
        except NotImplementedError as e:
            assert 'CPU' in str(e)
        else:
            raise AssertionError('an imvx operator ran on the CPU')
        bad = sorted(m for m in sys.modules
                     if m.split('.')[0].startswith(('jax', 'flax', 'cv2'))
                     or m == 'imvoxelnet_tpu'
                     or m.startswith('imvoxelnet_tpu.'))
        print('LOADED', bad)
        sys.exit(1 if bad else 0)
    ''')
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert 'LOADED []' in proc.stdout


def test_entry_points_default_to_the_card():
    """Every CLI's ``--device`` and every entry function's ``device``
    default to ``cuda``; only the caller asks for the CPU."""
    import inspect

    from imvoxelnet_tpu_torch import apis
    from imvoxelnet_tpu_torch.eval import runner
    from imvoxelnet_tpu_torch.models import detector
    from imvoxelnet_tpu_torch.tools import (demo, eval_nms_truncation,
                                            export, flops, test, train)
    from imvoxelnet_tpu_torch.tools.profile_forward import make_run
    from imvoxelnet_tpu_torch.utils import export as export_lib
    from imvoxelnet_tpu_torch.utils import synthetic

    argv = {demo: ['p', '--data-root', 'r', '--ann-file', 'a'],
            export: ['p', '--out', 'o'],
            test: ['p', '--data-root', 'r', '--ann-file', 'a'],
            train: ['p', '--data-root', 'r', '--ann-file', 'a',
                    '--work-dir', 'w'], flops: [], eval_nms_truncation: []}
    for module, args in argv.items():
        assert module.parse_args(args).device == 'cuda', module.__name__
    for fn in (apis.init_detector, detector.build_model, runner.run_inference,
               runner.evaluate_results, runner.build_val_dataset, make_run,
               export_lib.example_batch, synthetic.kitti_batch,
               synthetic.serving_batch):
        assert inspect.signature(fn).parameters['device'].default == 'cuda', \
            fn.__qualname__
