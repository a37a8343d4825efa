"""The port's measurement and data tools on the CPU (``imvoxelnet_tpu_torch/
tools``): the FLOP count (the analytic inventory against the JAX tool's,
``FlopCounterMode`` against it, B3's operator's formula), the synthetic
KITTI split and the truncation study's scene writer against the JAX
tools' (same seed, same pickles and pixels), the log summary against the
JAX tool's, the trace digest on a hand-written chrome trace, the loader
benchmark, and the tools that time the card stopping where there is none.
The JAX tools are imported from the root ``tools/`` by path.
"""

import importlib.util
import json
import os
import pickle

import numpy as np
import pytest
import torch

from imvoxelnet_tpu_torch.configs.presets import get_preset
from imvoxelnet_tpu_torch.data.datasets import KittiMultiViewDataset
from imvoxelnet_tpu_torch.data.image_io import load_image
from imvoxelnet_tpu_torch.data.pipeline import ImagePipelineConfig
from imvoxelnet_tpu_torch.tools import (analyze_logs, analyze_trace,
                                        bench_conv3z, bench_iou_kernel,
                                        bench_loader, bench_scatter,
                                        benchmark, eval_nms_truncation, flops,
                                        make_synthetic_kitti)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """The root ``tools/{name}.py`` as a module of its own name."""
    spec = importlib.util.spec_from_file_location(
        f'jax_tools_{name}', os.path.join(REPO, 'tools', f'{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_analytic_kitti_inventory_equals_the_jax_tool():
    jax_rows, jax_neck, jax_total = _jax_tool('flops').analytic_kitti()
    rows, neck, total = flops.analytic_kitti()
    assert rows == jax_rows and neck == jax_neck and total == jax_total
    # the speed of light at the H100's dense peaks, not a TPU's
    sol = flops.speed_of_light(total)
    assert sol == {'bfloat16': 989e12 / total, 'float32': 67e12 / total}


def test_flop_counter_equals_the_dense_inventory_on_the_neck():
    """``FlopCounterMode`` (``flops.count``) over shallow tiny KITTI's
    forward + decode (``profile_forward.make_run``; the plain convs on the
    CPU) counts the 3D neck's convs dense, as the analytic inventory does;
    B3's operator counts the same through its registered formula (meta
    tensors: its fake implementation runs)."""
    from imvoxelnet_tpu_torch.tools.profile_forward import make_run

    cfg = get_preset('tiny_kitti_test').model
    _, _, run = make_run('tiny_kitti_test', False, 1, 'float32',
                         device='cpu',
                         overrides=['model.backbone_stage_blocks=(1,1,1,1)'])
    total, by_module = flops.count(run)
    neck = by_module['ImVoxelNet.neck_3d']
    assert neck == sum(f for _, f in flops.kitti_neck_flops(
        *cfg.n_voxels, cfg.neck.in_channels, cfg.neck.out_channels))
    assert total > neck
    x = torch.empty(2, 8, 9, 12, 64, device='meta')
    k = torch.empty(3, 3, 3, 64, 64, device='meta')
    total, _ = flops.count(lambda: torch.ops.imvx.conv3x3x3(x, k))
    assert total == flops.conv_flops(64, 64, 2 * 8 * 9 * 12)


def test_synthetic_kitti_split_equals_the_jax_tool(tmp_path):
    """``make_split`` from both tools on the same base (``kitti_base``) and
    seed: the same info pickle, and frames that decode to the same pixels
    (the port's PNG against cv2's); the split reads back through
    ``KittiMultiViewDataset``."""
    cv2 = pytest.importorskip('cv2')
    jax_tool = _jax_tool('make_synthetic_kitti')
    base = make_synthetic_kitti.kitti_base(0)
    jax_root, root = tmp_path / 'jax', tmp_path / 'port'
    jax_tool.make_split(base, str(jax_root), 'val', 2,
                        np.random.RandomState(3), start_idx=5)
    make_synthetic_kitti.make_split(base, str(root), 'val', 2,
                                    np.random.RandomState(3), start_idx=5)
    ann = root / 'kitti_infos_val.pkl'
    assert ann.read_bytes() == (jax_root / 'kitti_infos_val.pkl').read_bytes()
    for idx in (5, 6):
        rel = f'training/image_2/{idx:06d}.png'
        want = cv2.imread(str(jax_root / rel))[:, :, ::-1]
        assert np.array_equal(load_image(str(root / rel)), want)
        assert np.array_equal(cv2.imread(str(root / rel))[:, :, ::-1], want)
    d = get_preset('imvoxelnet_kitti').data
    dataset = KittiMultiViewDataset(
        str(root), str(ann), d.classes, ImagePipelineConfig(
            test_scale=d.test_size, pad_size=(d.test_size[1],
                                              d.test_size[0])),
        max_gt=d.max_gt)
    sample = dataset.get_sample(1, False, np.random.RandomState(0))
    assert sample['images'].shape == (1, 384, 1280, 3)
    assert int(sample['gt_mask'].sum()) >= 1


def test_truncation_study_scene_writer_equals_the_jax_tool(tmp_path):
    pytest.importorskip('cv2')
    jax_tool = _jax_tool('eval_nms_truncation')
    for name, writer in (('jax', jax_tool.make_scene),
                         ('port', eval_nms_truncation.make_scene)):
        os.makedirs(tmp_path / name / 'image')
        rng = np.random.RandomState(5)
        out = [writer(rng, str(tmp_path / name), i) for i in range(3)]
        with open(tmp_path / f'{name}.pkl', 'wb') as f:
            pickle.dump(out, f)
    assert (tmp_path / 'port.pkl').read_bytes() == \
        (tmp_path / 'jax.pkl').read_bytes()
    for i in range(3):
        rel = f'image/{i:06d}.jpg'
        assert (tmp_path / 'port' / rel).read_bytes() == \
            (tmp_path / 'jax' / rel).read_bytes()


def _jax_tool_img_cfg(name):
    """The keywords of ``img_cfg = ImagePipelineConfig(...)`` in the root
    ``tools/{name}.py``, read from its source (it builds the config inside
    ``main``)."""
    import ast
    with open(os.path.join(REPO, 'tools', f'{name}.py')) as f:
        tree = ast.parse(f.read())
    calls = [node.value for node in ast.walk(tree)
             if isinstance(node, ast.Assign) and
             [getattr(t, 'id', None) for t in node.targets] == ['img_cfg']]
    assert len(calls) == 1
    return {kw.arg: ast.literal_eval(kw.value) for kw in calls[0].keywords}


def test_truncation_study_scenes_read_as_the_jax_tool_reads_them(tmp_path):
    """The study's frames through the port's ``IMAGES`` equal the JAX
    tool's through its ``img_cfg`` (640x480 at 320x240, an exact 2x
    downscale), bit for bit, with the same image metadata."""
    pytest.importorskip('cv2')
    from imvoxelnet_tpu.data.datasets import SunRgbdMultiViewDataset as Jds
    from imvoxelnet_tpu.data.pipeline import ImagePipelineConfig as JCfg

    from imvoxelnet_tpu_torch.data.datasets import SunRgbdMultiViewDataset

    jax_tool = _jax_tool('eval_nms_truncation')
    kw = _jax_tool_img_cfg('eval_nms_truncation')
    assert kw == dict(test_scale=(320, 256), pad_size=(256, 320))
    assert eval_nms_truncation.IMAGES == ImagePipelineConfig(**kw)
    made = []
    for name, writer, dataset, img_cfg in (
            ('jax', jax_tool.make_scene, Jds, JCfg(**kw)),
            ('port', eval_nms_truncation.make_scene,
             SunRgbdMultiViewDataset, eval_nms_truncation.IMAGES)):
        root = tmp_path / name
        os.makedirs(root / 'image')
        rng = np.random.RandomState(6)
        infos = [writer(rng, str(root), i)[0] for i in range(2)]
        with open(root / 'infos.pkl', 'wb') as f:
            pickle.dump(infos, f)
        ds = dataset(str(root), str(root / 'infos.pkl'),
                     eval_nms_truncation.CLASSES, img_cfg, max_gt=8)
        made.append([ds.get_sample(i, False, np.random.RandomState(0))
                     for i in range(2)])
    for ref, got in zip(*made):
        assert got['images'].shape == ref['images'].shape == (1, 256, 320, 3)
        assert got['images'].tobytes() == ref['images'].tobytes()
        assert tuple(got['img_shape']) == (240, 320)
        assert sorted(got) == sorted(ref)
        for key in ref:
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(ref[key]), err_msg=key)


def test_analyze_logs_summary_equals_the_jax_tool(tmp_path, monkeypatch,
                                                  capsys):
    log = tmp_path / 'train_log.jsonl'
    with open(log, 'w') as f:
        for i in range(6):
            line = dict(step=i, loss=2.0 - 0.3 * i, lr=1e-4)
            if i % 2:
                line['loss_cls'] = 0.5 / (i + 1)
            f.write(json.dumps(line) + '\n')
    keys = ['loss', 'loss_cls', 'missing']
    monkeypatch.setattr('sys.argv', ['analyze_logs.py', str(log), '--keys',
                                     *keys])
    _jax_tool('analyze_logs').main()
    want = capsys.readouterr().out
    got = analyze_logs.main([str(log), '--keys', *keys])
    assert capsys.readouterr().out == want
    assert got['loss'] == dict(first=2.0, last=2.0 - 0.3 * 5,
                               min=2.0 - 0.3 * 5, max=2.0, n=6)
    assert got['loss_cls']['n'] == 3 and 'missing' not in got


def _trace():
    """A chrome trace as ``torch.profiler`` writes one: python frames on
    the host thread, runtime calls with correlation ids inside them, the
    device events they launched, two ``benchmark_iter`` spans, and a
    backward kernel launched from the autograd engine's thread (no Python
    frame) inside the backward of the head's conv (sequence number 7)."""
    host, dev = dict(pid=1, tid=1), dict(pid=0, tid=7)
    engine = dict(pid=1, tid=2)

    def frame(name, ts, dur):
        return dict(ph='X', cat='python_function', name=name, ts=ts, dur=dur,
                    **host)

    def call(name, ts, corr):
        return dict(ph='X', cat='cuda_runtime', name=name, ts=ts, dur=2,
                    args=dict(correlation=corr), **host)

    def device(cat, name, ts, dur, corr):
        return dict(ph='X', cat=cat, name=name, ts=ts, dur=dur,
                    args=dict(correlation=corr), **dev)
    return [
        frame('imvoxelnet_tpu_torch/models/necks3d.py(54): forward', 0, 100),
        frame('imvoxelnet_tpu_torch/ops/conv3z.py(82): conv3x3x3', 10, 50),
        frame('torch/_library/custom_ops.py(600): __call__', 12, 40),
        frame('nn.Module: Conv3d_0', 13, 30),
        frame('imvoxelnet_tpu_torch/kernels/conv3x3x3.py(210): conv3x3x3',
              15, 30),
        frame('imvoxelnet_tpu_torch/models/heads/anchor3d_head.py(80): '
              'forward', 200, 50),
        frame('somelib/wrap.py(3): call', 204, 26),
        frame('torch/nn/modules/conv.py(546): _conv_forward', 205, 20),
        call('cudaLaunchKernel', 20, 1), call('cudaLaunchKernel', 40, 2),
        call('cudaLaunchKernel', 210, 3), call('cudaMemcpyAsync', 300, 4),
        dict(ph='X', cat='cpu_op', name='aten::conv3d', ts=208, dur=10,
             args={'Sequence number': 7, 'Fwd thread id': 0}, **host),
        dict(ph='X', cat='cpu_op', name='autograd::engine::evaluate_function:'
             ' ConvolutionBackward0', ts=395, dur=20,
             args={'Sequence number': 7, 'Fwd thread id': 1}, **engine),
        dict(ph='X', cat='cuda_runtime', name='cudaLaunchKernel', ts=400,
             dur=2, args=dict(correlation=5), **engine),
        device('kernel', 'dgrad_kernel', 3500, 300, 5),
        device('kernel', 'conv_wgmma_kernel', 500, 1000, 1),
        device('kernel', 'conv_wgmma_kernel', 1600, 1000, 2),
        device('kernel', 'cudnn_conv_kernel', 2700, 500, 3),
        device('gpu_memcpy', 'Memcpy DtoH (Device -> Pinned)', 3300, 100, 4),
        dict(ph='X', cat='user_annotation', name='benchmark_iter', ts=0,
             dur=260, **host),
        dict(ph='X', cat='user_annotation', name='benchmark_iter', ts=280,
             dur=50, **host),
        dict(ph='M', name='process_name', pid=0, args=dict(name='GPU 0')),
    ]


@pytest.mark.parametrize('case', ['kernels', 'bucket', 'by_source',
                                  'by_line', 'repo_source', 'steps'])
def test_trace_digest(case, tmp_path, capsys):
    path = tmp_path / 'benchmark_trace.json'
    path.write_text(json.dumps(dict(traceEvents=_trace())))
    argv = {'kernels': [], 'bucket': ['--bucket', 'convs=conv'],
            'by_source': ['--by-source'],
            'by_line': ['--by-source', '--by-line'],
            'repo_source': ['--by-source', '--repo-source'],
            'steps': ['--steps', '2']}[case]
    # a directory reads its newest trace
    out = analyze_trace.main([str(tmp_path)] + argv)
    rows = {r['name']: (round(r['ms'], 6), r['calls']) for r in out['table']}
    assert out['device_ms'] == pytest.approx(2.9)
    assert out['kernel_ms'] == pytest.approx(2.8)
    assert out['spans'] == dict(count=2, host_ms=pytest.approx(0.155),
                                device_ms=pytest.approx(1.3))
    memcpy = 'Memcpy DtoH (Device -> Pinned)'
    neck = 'imvoxelnet_tpu_torch/models/necks3d.py'
    head = 'imvoxelnet_tpu_torch/models/heads/anchor3d_head.py'
    want = {
        'kernels': {'conv_wgmma_kernel': (2.0, 2),
                    'cudnn_conv_kernel': (0.5, 1), 'dgrad_kernel': (0.3, 1),
                    memcpy: (0.1, 1)},
        'bucket': {'convs': (2.5, 3), 'dgrad_kernel': (0.3, 1),
                   memcpy: (0.1, 1)},
        # B3's launches skip the kernel and op layers and PyTorch's
        # frames; the library frame outside the repository is kept; the
        # backward kernel goes to its forward operator's code
        'by_source': {neck: (2.0, 2), 'somelib/wrap.py': (0.5, 1),
                      'somelib/wrap.py (backward)': (0.3, 1),
                      f'(no source: {memcpy})': (0.1, 1)},
        'by_line': {f'{neck}:54': (2.0, 2), 'somelib/wrap.py:3': (0.5, 1),
                    'somelib/wrap.py:3 (backward)': (0.3, 1),
                    f'(no source: {memcpy})': (0.1, 1)},
        'repo_source': {neck: (2.0, 2), head: (0.5, 1),
                        f'{head} (backward)': (0.3, 1),
                        f'(no source: {memcpy})': (0.1, 1)},
        'steps': {'conv_wgmma_kernel': (1.0, 2),
                  'cudnn_conv_kernel': (0.25, 1), 'dgrad_kernel': (0.15, 1),
                  memcpy: (0.05, 1)},
    }[case]
    assert rows == want
    if case == 'by_source':
        # each kernel's sources, for a caller that checks where one went
        assert out['sources'] == {
            'conv_wgmma_kernel': [neck], 'cudnn_conv_kernel': [
                'somelib/wrap.py'], 'dgrad_kernel': [
                'somelib/wrap.py (backward)'], memcpy: [
                f'(no source: {memcpy})']}
    text = capsys.readouterr().out
    assert '2 benchmark_iter spans' in text
    assert ('ms/step' in text) == (case == 'steps')


def test_trace_window():
    """The spans as one window: the kernels launched in them (those of
    correlations 1-3; the engine's is launched after them), the card's
    busy share of their device window, the host calls in it that wait for
    the device and the device-to-host copies in it (the spans' copy runs
    after their last kernel)."""
    events = _trace()
    got = analyze_trace.window(events, 'benchmark_iter', 2)
    assert got == dict(steps=2, host_window_ms=0.33,
                       device_window_ms=pytest.approx(2.7), kernels=3,
                       runtime_calls=4, sync_calls=[],
                       device_to_host_copies=0,
                       busy_share=pytest.approx(2.5 / 2.7))
    events.append(dict(ph='X', cat='cuda_runtime', ts=250, dur=5, args={},
                       name='cudaDeviceSynchronize', pid=1, tid=1))
    events.append(dict(ph='X', cat='gpu_memcpy', name='Memcpy DtoH',
                       ts=1550, dur=10, args={}, pid=0, tid=7))
    got = analyze_trace.window(events, 'benchmark_iter', 2)
    assert got['sync_calls'] == ['cudaDeviceSynchronize']
    assert got['device_to_host_copies'] == 1
    with pytest.raises(AssertionError, match='2 benchmark_iter spans, not 3'):
        analyze_trace.window(events, 'benchmark_iter', 3)


def test_loader_benchmark_on_a_written_split(capsys):
    out = bench_loader.main(['--samples', '8', '--batch-size', '4',
                             '--workers', '1,2', '--target', '50'])
    assert [r['workers'] for r in out['runs']] == [1, 2]
    cpu = min(r['cpu_ms_per_sample'] for r in out['runs'])
    assert out['cores_for_target'] == pytest.approx(50 * cpu / 1e3)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == \
        out


@pytest.mark.parametrize('tool, argv', [
    (benchmark, ['imvoxelnet_kitti']), (bench_conv3z, []),
    (bench_iou_kernel, ['--nms']), (bench_scatter, []),
    (flops, ['imvoxelnet_kitti']),
    (eval_nms_truncation, ['--steps', '1'])])
def test_card_tools_stop_without_a_card(tool, argv, monkeypatch):
    """No fallback: a tool that times or counts on the card stops when no
    card is visible, before it builds a model."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        tool.main(argv)
    assert e.value.code not in (0, None)
