"""Total3D's learning loop in either package, on either scene, from the JAX
package's initial weights: the evidence behind the port's Total3D schedule
(``imvoxelnet_tpu_torch/tools/validate_learning.py``; PERF.md §6, PR 12).

    JAX_PLATFORMS=cpu python tests/_torch_port_total3d_lr.py \\
        --package {jax,port} --scene {script,port} --seed N \\
        [--lr 3e-3] [--epoch-steps 1000]

The weights are the JAX package's ``PRNGKey(seed)`` init; the port loads
them through ``from_jax_variables``.  Both packages train 300 steps on the
same host batch, made by the JAX dataset, with ``make_optimizer(lr, 1e-4,
0.1, 35.0, epoch_steps)``, serve it on the extrinsics they predict, and
score it with the JAX package's protocol against the JAX script's
criterion.  Scene ``script`` is ``tools/validate_learning_total3d.py``'s
(a 640x480 JPEG resized to 320x240; the stored box centre 0.5 m under the
blob); scene ``port`` is ``utils/synthetic_splits.py:
sunrgbd_learning_scene(total3d=True)`` (a PNG resized to 320x240, as the
port's ``INDOOR_IMAGES`` reads it; the box centred on the blob).  Prints
one JSON line: the metrics, whether the criterion held and the losses of
every step.
"""

import argparse
import json
import os
import pickle
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

STEPS = 300
CRITERIA = {'mAP_0.15': ('>', 0.99), 'pitch_mae': ('<', 1.5),
            'roll_mae': ('<', 1.5), 'layout_iou': ('>', 0.5)}


def script_scene(root):
    """``tools/validate_learning_total3d.py``'s scene, written as it writes
    it."""
    import cv2
    import jax.numpy as jnp

    from imvoxelnet_tpu.models.heads.layout_head import predicted_extrinsics

    os.makedirs(root + '/image')
    rng = np.random.RandomState(0)
    gt_angles = np.array([0.08, -0.05], np.float32)
    gt_layout = np.array([0.2, 3.2, 0.3, 5.0, 6.0, 3.0, 0.1], np.float32)
    box = np.array([0.5, 3.0, -0.5, 1.0, 1.0, 1.0, 0.3])
    ext = np.asarray(predicted_extrinsics(jnp.asarray(gt_angles[None])))[0]
    e = ext[:3, :3].T
    rt = np.stack([e[:, 0], e[:, 2], -e[:, 1]], axis=1)
    fx, cx, cy = 400.0, 320.0, 240.0
    k = np.array([[fx, 0, 0], [0, fx, 0], [cx, cy, 1]], np.float64)
    cam = ext[:3, :3] @ np.array([box[0], box[1], box[2] + box[5] / 2])
    u = int(fx * cam[0] / cam[2] + cx)
    v = int(fx * cam[1] / cam[2] + cy)
    img = rng.randint(0, 60, (480, 640, 3), np.uint8)
    cv2.rectangle(img, (u - 60, v - 60), (u + 60, v + 60), (255, 255, 255),
                  -1)
    cv2.imwrite(root + '/image/000001.jpg', img)
    info = dict(
        image=dict(image_idx=1, image_path='image/000001.jpg',
                   image_shape=np.array([480, 640], np.int32)),
        calib=dict(K=k.reshape(-1), Rt=rt.astype(np.float64)),
        annos=dict(gt_num=1, gt_boxes_upright_depth=box[None],
                   name=np.array(['bed']), **{'class': np.array([0])}),
        angles=gt_angles, layout=gt_layout)
    path = root + '/infos.pkl'
    with open(path, 'wb') as f:
        pickle.dump([info], f)
    return path


def run(package, scene, seed, lr, epoch_steps):
    import jax

    from imvoxelnet_tpu.configs import presets
    from imvoxelnet_tpu.data.datasets import SunRgbdTotalMultiViewDataset
    from imvoxelnet_tpu.data.pipeline import ImagePipelineConfig
    from imvoxelnet_tpu.eval import runner
    from imvoxelnet_tpu.models.detector import (
        ImVoxelNet, ImVoxelNetConfig, NeckConfig, imvoxelnet_predict)
    from imvoxelnet_tpu.models.heads.imvoxel_heads import IndoorHeadConfig
    from imvoxelnet_tpu.models.heads.layout_head import LayoutHeadConfig
    from imvoxelnet_tpu.parallel import train as train_lib
    from imvoxelnet_tpu_torch.tools import validate_learning as vl
    from imvoxelnet_tpu_torch.utils import synthetic_splits

    cfg = ImVoxelNetConfig(                 # the JAX script's config
        n_voxels=(16, 16, 8), voxel_size=(0.4, 0.4, 0.4),
        fpn_out_channels=16,
        neck=NeckConfig(kind='fast', in_channels=16, out_channels=16,
                        n_blocks=(1, 1, 1)),
        head_kind='indoor', anchor_head=None,
        indoor_head=IndoorHeadConfig(
            n_classes=1, n_reg_outs=7, voxel_size=(0.4, 0.4, 0.4),
            dataset='sunrgbd', version=1, nms_pre=128, score_thr=0.05,
            iou_thr=0.15, max_out=8, pre_nms_k=32),
        layout_head=LayoutHeadConfig(linear_size=64))
    port_cfg = vl.families()['total3d'].cfg   # the same, the port's
    root = tempfile.mkdtemp()
    if scene == 'script':
        ann = script_scene(root)
        images = ImagePipelineConfig(test_scale=(320, 256),
                                     pad_size=(256, 320))
    else:
        ann = synthetic_splits.sunrgbd_learning_scene(root, total3d=True)
        v = vl.INDOOR_IMAGES
        images = ImagePipelineConfig(test_scale=v.test_scale,
                                     pad_size=v.pad_size)
    ds = SunRgbdTotalMultiViewDataset(root, ann, ('bed',), images, max_gt=4)
    batch = ds.collate([ds.get_sample(0, False, np.random.RandomState(0))])

    model = ImVoxelNet(cfg)
    tx = train_lib.make_optimizer(lr, 1e-4, 0.1, 35.0, epoch_steps)
    state = train_lib.create_train_state(model, tx, jax.random.PRNGKey(seed),
                                         batch)
    losses = []
    if package == 'jax':
        step = jax.jit(train_lib.make_train_step(model, tx))
        for _ in range(STEPS):
            state, m = step(state, batch)
            losses.append({k: float(x) for k, x in m.items()})
        outs = model.apply({'params': state.params,
                            'batch_stats': state.batch_stats}, batch,
                           train=False)
        pred = jax.device_get(imvoxelnet_predict(cfg, *outs, batch))
    else:
        import torch

        from imvoxelnet_tpu_torch.eval import runner as port_runner
        from imvoxelnet_tpu_torch.models.detector import ImVoxelNet as Port
        from imvoxelnet_tpu_torch.parallel import train as port_train
        from imvoxelnet_tpu_torch.utils.checkpoint import from_jax_variables

        port = Port(port_cfg)
        port.load_state_dict(from_jax_variables(jax.device_get(
            {'params': state.params, 'batch_stats': state.batch_stats}),
            port_cfg), strict=True)
        tbatch = {k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in batch.items()}
        opt, sched = port_train.make_optimizer(port, lr, 1e-4, 0.1, 35.0,
                                               epoch_steps)
        step = port_train.make_train_step(port, opt, sched)
        for _ in range(STEPS):
            losses.append({k: float(x) for k, x in step(tbatch).items()})
        port.eval()
        pred = {k: v.numpy() for k, v in
                port_runner.forward(port, port_cfg, tbatch).items()}
    valid = pred['valid'][0]
    results = [dict(boxes=pred['boxes'][0][valid],
                    scores=pred['scores'][0][valid],
                    labels=pred['labels'][0][valid],
                    angles=pred['angles'][0], layout=pred['layout'][0])]
    preset = presets.Preset(
        name='imvoxelnet_total_sunrgbd_tiny', model=cfg,
        data=presets.DataConfig(dataset='sunrgbd', classes=('bed',)))
    metrics = runner.evaluate_results(preset, preset.name, ds, results)
    metrics = {k: float(metrics[k]) for k in CRITERIA}
    held = all(metrics[k] > b if op == '>' else metrics[k] < b
               for k, (op, b) in CRITERIA.items())
    return dict(package=package, scene=scene, seed=seed, lr=lr,
                epoch_steps=epoch_steps, metrics=metrics, passed=held,
                first_nan_step=next((i for i, m in enumerate(losses)
                                     if not np.isfinite(m['loss'])), None),
                losses=losses)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--package', choices=('jax', 'port'), required=True)
    parser.add_argument('--scene', choices=('script', 'port'), required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--lr', type=float, default=3e-3)
    parser.add_argument('--epoch-steps', type=int, default=1000)
    args = parser.parse_args()
    print(json.dumps(run(args.package, args.scene, args.seed, args.lr,
                         args.epoch_steps)))


if __name__ == '__main__':
    main()
