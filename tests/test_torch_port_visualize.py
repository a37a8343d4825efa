"""The port's visualization, ``--show-dir``, BN fold and small CLIs on the
CPU: ``draw_boxes`` and ``export_boxes_obj`` against the JAX package's,
``show_multi_view_result`` and ``tools/test.py --show-dir`` on a split
written by ``utils/synthetic_splits.py``, ``utils/fuse.py`` against the JAX
package's ``tools/fuse_conv_bn.py`` and the folded forward against the
unfolded one, and ``tools/publish_model.py`` / ``print_config.py``.
"""

import copy
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from imvoxelnet_tpu.configs import presets as jax_presets
from imvoxelnet_tpu.utils import visualize as jax_vis
from imvoxelnet_tpu_torch.configs import presets
from imvoxelnet_tpu_torch.data.image_io import load_image
from imvoxelnet_tpu_torch.eval import runner
from imvoxelnet_tpu_torch.models.detector import build_model
from imvoxelnet_tpu_torch.tools import demo
from imvoxelnet_tpu_torch.tools import fuse_conv_bn as fuse_tool
from imvoxelnet_tpu_torch.tools import print_config, publish_model
from imvoxelnet_tpu_torch.tools import test as test_tool
from imvoxelnet_tpu_torch.utils import checkpoint as ckpt_lib
from imvoxelnet_tpu_torch.utils import fuse
from imvoxelnet_tpu_torch.utils import synthetic_splits as splits
from imvoxelnet_tpu_torch.utils import visualize as vis
from imvoxelnet_tpu_torch.utils.checkpoint import from_jax_variables

from _torch_port_fixtures import (jax_variables, port_model, tiny_batch_np,
                                  tiny_nuscenes_cfgs, to_torch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHALLOW = 'model.backbone_stage_blocks=(1,1,1,1)'
# cars in front of a KITTI camera (lidar frame), some partly out of view,
# one behind it
BOXES = np.array([[20.0, 0.0, -1.5, 1.6, 3.9, 1.56, 0.3],
                  [15.0, -3.0, -1.5, 0.6, 0.8, 1.73, -1.2],
                  [8.0, 6.5, -1.6, 1.7, 4.1, 1.5, 2.0],
                  [-5.0, 0.0, -1.5, 1.6, 3.9, 1.56, 0.0]], np.float32)


def _projection():
    k = np.array([[721.5, 0, 609.6], [0, 721.5, 172.9], [0, 0, 1]],
                 np.float32)
    lidar_to_cam = np.array([[0, -1, 0, 0.0], [0, 0, -1, -0.08],
                             [1, 0, 0, -0.27], [0, 0, 0, 1]], np.float32)
    return k @ lidar_to_cam[:3]


def _jax_fuse():
    spec = importlib.util.spec_from_file_location(
        'jax_fuse_conv_bn', os.path.join(REPO, 'tools', 'fuse_conv_bn.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_draw_boxes_and_obj_equal_jax(tmp_path):
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (375, 1242, 3)).astype(np.uint8)
    for thickness in (1, 2):
        got = vis.draw_boxes(image, BOXES, _projection(),
                             thickness=thickness)
        want = jax_vis.draw_boxes(image, BOXES, _projection(),
                                  thickness=thickness)
        np.testing.assert_array_equal(got, want)
        assert (got != image).any(-1).sum() > 100
    np.testing.assert_array_equal(
        vis.draw_boxes(image, BOXES[3:], _projection()), image)
    np.testing.assert_array_equal(vis.draw_boxes(image, BOXES[:0],
                                                 _projection()), image)
    got = vis.export_boxes_obj(BOXES, str(tmp_path / 'port.obj'))
    want = jax_vis.export_boxes_obj(BOXES, str(tmp_path / 'jax.obj'))
    with open(got) as f, open(want) as g:
        text = f.read()
        assert text == g.read()
    assert text.count('\nv ') + text.startswith('v ') == 8 * len(BOXES)
    assert text.count('\nl ') == 12 * len(BOXES)


def test_show_multi_view_result_and_the_test_tool_show_dir(tmp_path):
    """The tool on a 2-frame split: the first ``--show-num`` samples'
    detections above ``--show-score-thr`` drawn into their frames (read
    with the port's PNG decode), the rest untouched."""
    root = str(tmp_path / 'kitti')
    ann = splits.kitti_split(root, 2, seed=1, frame_hw=(94, 310))
    show = str(tmp_path / 'show')
    summary = test_tool.main(['tiny_kitti_test', '--data-root', root,
                              '--ann-file', ann, '--device', 'cpu',
                              '--num-workers', '1', '--batch-size', '2',
                              '--override', SHALLOW,
                              '--override',
                              'model.anchor_head.score_thr=0.0',
                              '--show-dir', show, '--show-num', '1',
                              '--show-score-thr', '0.0'])
    assert summary['shown'] == [os.path.join(show, '0_0.png')]
    preset = presets.get_preset('tiny_kitti_test')
    dataset, _ = runner.build_val_dataset(preset, 'tiny_kitti_test', root,
                                          ann, device='cpu')
    frame = load_image(os.path.join(root, dataset.get_data_info(0)[
        'img_paths'][0]))
    drawn = load_image(summary['shown'][0])
    assert drawn.shape == frame.shape == (94, 310, 3)
    assert len(summary['results'][0]['boxes']) > 0
    np.testing.assert_array_equal(
        drawn, vis.draw_boxes(frame, summary['results'][0]['boxes'],
                              np.asarray(dataset.get_data_info(0)[
                                  'intrinsic'], np.float32)[:3, :3]
                              @ np.asarray(dataset.get_data_info(0)[
                                  'extrinsics'][0], np.float32)[:3]))
    # boxes far behind the camera: the PNG is the frame itself
    paths = vis.show_multi_view_result(dataset, 1, BOXES[3:],
                                       str(tmp_path / 'behind'))
    np.testing.assert_array_equal(load_image(paths[0]), load_image(
        os.path.join(root, dataset.get_data_info(1)['img_paths'][0])))
    # the demo on sample 1: the API's detections, drawn, and the .obj
    out = demo.main(['tiny_kitti_test', '--data-root', root, '--ann-file',
                     ann, '--index', '1', '--out-dir',
                     str(tmp_path / 'demo'), '--obj', '--device', 'cpu'])
    assert [os.path.basename(p) for p in out['paths']] == ['1_0.png',
                                                            '1.obj']
    assert all(os.path.getsize(p) for p in out['paths'])


def test_drawing_without_cv2_raises(monkeypatch):
    """No fallback: without cv2 the drawing raises ImportError naming
    it."""
    import sys

    monkeypatch.setitem(sys.modules, 'cv2', None)
    with pytest.raises(ImportError, match='cv2'):
        vis.draw_boxes(np.zeros((8, 8, 3), np.uint8), BOXES, _projection())


def test_fold_equals_the_jax_fold_and_keeps_the_forward():
    """The fold of a random state (nonidentity frozen BNs) against the JAX
    package's ``fuse_backbone`` on the same tree carried across, and the
    folded shallow ``tiny_kitti_test`` forward against the unfolded one
    (float32, 1e-5 of max-abs)."""
    jcfg = jax_presets.apply_overrides(
        jax_presets.get_preset('tiny_kitti_test'), [SHALLOW]).model
    cfg = presets.apply_overrides(presets.get_preset('tiny_kitti_test'),
                                  [SHALLOW]).model
    batch_np = tiny_batch_np(1, seed=3)
    variables = jax_variables(jcfg, batch_np, seed=7, cls_bias=0.0)
    folded = copy.deepcopy(variables)
    folded['params'] = _jax_fuse().fuse_backbone(folded['params'])
    want = from_jax_variables(folded, cfg)
    state = from_jax_variables(variables, cfg)
    got = fuse.fuse_backbone(state)
    assert set(got) == set(want) == set(state)
    n_changed = 0
    for key, val in want.items():
        np.testing.assert_allclose(got[key].numpy(), val.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=key)
        n_changed += not torch.equal(got[key], state[key])
    # stem + 4 blocks x 3 convs + 4 downsamples, each conv and its BN's
    # weight, bias, mean and var
    assert n_changed == (1 + 4 * 3 + 4) * 5
    model = port_model(cfg, variables)
    fused = copy.deepcopy(model)
    fused.load_state_dict(got, strict=True)
    batch = to_torch(batch_np)
    with torch.no_grad():
        a = model(batch)[0]
        b = fused(batch)[0]
    for x, y in zip(a, b):
        assert (x - y).abs().max() <= 1e-5 * y.abs().max()


def test_fold_of_a_dcn_backbone_keeps_its_stages():
    """nuScenes' DCN blocks: ``conv2.weight`` folded, ``conv_offset``
    kept, every stage of the shallow backbone within 1e-5 of max-abs."""
    _, cfg = tiny_nuscenes_cfgs()
    model = build_model(cfg, device='cpu', seed=0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for key, val in model.state_dict().items():
            if key.startswith('backbone.') and 'bn' in key or \
                    'downsample.1' in key or 'conv_offset' in key:
                if val.is_floating_point():
                    val.copy_(torch.rand(val.shape, generator=gen) + 0.5
                              if 'var' in key or key.endswith('bn1.weight')
                              else 0.1 * torch.randn(val.shape,
                                                     generator=gen))
    state = model.state_dict()
    got = fuse.fuse_backbone(state)
    assert torch.equal(got['backbone.layer3.0.conv2.conv_offset.weight'],
                       state['backbone.layer3.0.conv2.conv_offset.weight'])
    assert not torch.equal(got['backbone.layer3.0.conv2.weight'],
                           state['backbone.layer3.0.conv2.weight'])
    fused = copy.deepcopy(model)
    fused.load_state_dict(got, strict=True)
    x = torch.randn(2, 3, 64, 96, generator=gen)
    with torch.no_grad():
        for a, b in zip(model.backbone(x), fused.backbone(x)):
            assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def test_fuse_publish_and_print_config_clis(tmp_path, capsys):
    cfg = presets.apply_overrides(presets.get_preset('tiny_kitti_test'),
                                  [SHALLOW]).model
    model = build_model(cfg, device='cpu', seed=0)
    path = str(tmp_path / 'latest.pth')
    torch.save({'state_dict': model.state_dict(), 'meta': {'epoch': 3},
                'optimizer': {'state': {}}, 'step': 7}, path)
    out = fuse_tool.main([path, str(tmp_path / 'fused.pth')])
    payload = torch.load(out, weights_only=True)
    assert payload['step'] == 7
    want = fuse.fuse_backbone(model.state_dict())
    for key, val in want.items():
        assert torch.equal(payload['state_dict'][key], val), key
    published = publish_model.main([path, str(tmp_path / 'model.pth')])
    name = os.path.basename(published)
    assert name.startswith('model-') and name.endswith('.pth')
    assert len(name) == len('model-12345678.pth')
    slim = torch.load(published, weights_only=True)
    assert set(slim) == {'state_dict', 'meta'}
    loaded = ckpt_lib.load_reference_state_dict(published)
    assert all(torch.equal(loaded[k], v)
               for k, v in model.state_dict().items())
    assert publish_model.main([path, str(tmp_path / 'model.pth')]) == \
        published                               # the hash is the content's
    capsys.readouterr()
    assert print_config.main([]) == sorted(presets.PRESETS)
    config = print_config.main(['tiny_kitti_test', '--override',
                                'model.anchor_head.score_thr=0.5'])
    assert config['model']['anchor_head']['score_thr'] == 0.5
    assert dataclasses.asdict(presets.get_preset('tiny_kitti_test'))[
        'data'] == config['data']
    assert 'tiny_kitti_test' in capsys.readouterr().out
    with pytest.raises(SystemExit):
        print_config.main(['--bogus'])
