"""Shared inputs for the PyTorch port's parity tests (``test_torch_port_*``).

Both packages get the same numpy inputs and the same weights: a random
numpy tree shaped like the JAX ``ImVoxelNet``'s variables, which the port
loads through ``from_jax_variables``.
"""

import numpy as np

H, W = 96, 320                       # tiny_kitti_test image size
RATIO = 4.0                          # ori_h / (img_h / stride), ori == img
# KITTI camera 2 scaled to 320x96, cx/cy nudged off the pixel grid
K_TINY = np.array([[180.38, 0.0, 160.37], [0.0, 180.38, 43.21],
                   [0.0, 0.0, 1.0]], np.float32)
LIDAR_TO_CAM = np.array([[0, -1, 0, 0.0], [0, 0, -1, -0.08],
                         [1, 0, 0, -0.27], [0, 0, 0, 1]], np.float32)
# tiny grid is 25.6 x 25.6 x 3.84 m; its center sits off the voxel grid
ORIGIN = (12.8 - 0.0341, -0.039, -1.0 + 0.0156)


def tiny_batch_np(b, seed=0):
    rng = np.random.RandomState(seed)
    return dict(
        images=rng.randn(b, 1, H, W, 3).astype(np.float32),
        intrinsics=np.stack([K_TINY] * b),
        extrinsics=np.stack([LIDAR_TO_CAM[None]] * b),
        origins=np.asarray([ORIGIN] * b, np.float32),
        img_shape=np.asarray([[H, W]] * b, np.int32),
        ratios=np.full((b,), RATIO, np.float32),
    )


def projection_margin(n_voxels, voxel_size, batch_np, stride=4):
    """Smallest distance, in float64, of any in-front voxel's projected
    pixel coordinate from a round-half boundary.  Float32 paths that
    evaluate the projection in different orders pick the same pixel when
    this is well above float32 noise (~1e-5)."""
    n = np.asarray(n_voxels, np.float64)
    vs = np.asarray(voxel_size, np.float64)
    idx = np.stack(np.meshgrid(*[np.arange(c) for c in n_voxels],
                               indexing='ij'), -1).reshape(-1, 3)
    margin = np.inf
    for i in range(batch_np['origins'].shape[0]):
        o = batch_np['origins'][i].astype(np.float64)
        pts = idx * vs + (o - n / 2.0 * vs)
        k = batch_np['intrinsics'][i].astype(np.float64).copy()
        k[:2] /= batch_np['ratios'][i]
        for e in batch_np['extrinsics'][i]:
            uvw = (k @ e[:3].astype(np.float64) @ np.c_[
                pts, np.ones(len(pts))].T).T
            front = uvw[:, 2] > 0
            for a in (uvw[front, 0] / uvw[front, 2],
                      uvw[front, 1] / uvw[front, 2]):
                margin = min(margin, np.abs((a - np.floor(a)) - 0.5).min())
    return margin


def random_tree(shapes, rng, path=()):
    """Numpy weights for a tree of shapes: lecun-normal conv kernels
    (normal(0.01) for the head's cls/reg convs, as the JAX init), random
    biases and batch-norm statistics."""
    out = {}
    for key, val in shapes.items():
        if hasattr(val, 'items'):
            out[key] = random_tree(val, rng, path + (key,))
            continue
        shape = val.shape
        if key == 'kernel':
            std = (0.01 if path[-1] in ('conv_cls', 'conv_reg')
                   else np.prod(shape[:-1]) ** -0.5)
            val = rng.randn(*shape) * std
        elif key in ('scale', 'var'):
            val = rng.uniform(0.5, 1.5, shape)
        else:                                   # bias, mean
            val = rng.randn(*shape) * 0.1
        out[key] = val.astype(np.float32)
    return out


def jax_variables(cfg, batch_np, seed=0, cls_bias=None):
    """Random ``{'params', 'batch_stats'}`` (numpy) for the JAX
    ``ImVoxelNet(cfg)``, shaped by an abstract ``init``; ``cls_bias``
    overrides the head's cls bias."""
    import jax
    import jax.numpy as jnp

    from imvoxelnet_tpu.models.detector import ImVoxelNet

    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    shapes = jax.eval_shape(
        lambda b: ImVoxelNet(cfg).init(jax.random.PRNGKey(0), b,
                                       train=False), batch)
    variables = random_tree(shapes, np.random.RandomState(seed))
    if cls_bias is not None:
        head = variables['params']['bbox_head']
        conv = head['conv_cls' if 'conv_cls' in head else 'cls_conv']
        conv['bias'] = np.full_like(conv['bias'], cls_bias)
    return variables


def to_torch(batch_np, device='cpu'):
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch_np.items()}


def port_model(cfg, variables, device='cpu'):
    """The port's ``ImVoxelNet`` for the same config and weights, eval."""
    from imvoxelnet_tpu_torch.models.detector import ImVoxelNet
    from imvoxelnet_tpu_torch.utils.checkpoint import from_jax_variables

    model = ImVoxelNet(cfg)
    model.load_state_dict(from_jax_variables(variables, cfg), strict=True)
    return model.to(device).eval()


def tiny_indoor_cfgs(fast=False, version=None, n_convs=0):
    """The same tiny SUN RGB-D config in both packages (JAX, port), built
    as ``tests/test_models.py:_tiny_indoor_cfg`` builds it: ResNet stages
    (1, 1, 1, 1), FPN 16, 16x16x8 voxels of 0.4 m, 3 classes, ``pre_nms_k``
    32; v1 (ImVoxelNeck) or ``fast`` (the fast neck, head v2)."""
    from imvoxelnet_tpu.models import detector as jdet
    from imvoxelnet_tpu.models.heads import imvoxel_heads as jivh
    from imvoxelnet_tpu_torch.models import detector as tdet
    from imvoxelnet_tpu_torch.models.heads import imvoxel_heads as tivh

    if fast:
        neck = dict(kind='fast', in_channels=16, out_channels=16,
                    n_blocks=(1, 1, 1))
    else:
        neck = dict(kind='imvoxel', channels=(16, 24, 32, 48),
                    out_channels=16, down_layers=(1, 1, 1, 1),
                    up_layers=(1, 1, 1))
    version = version or (2 if fast else 1)
    head = dict(n_classes=3, n_reg_outs=7, voxel_size=(0.4, 0.4, 0.4),
                dataset='sunrgbd', version=version, n_convs=n_convs,
                centerness_topk=4 if version == 2 else -1, limit=8,
                nms_pre=64, score_thr=0.01, iou_thr=0.15, max_out=16,
                pre_nms_k=32)
    out = []
    for det, ivh in ((jdet, jivh), (tdet, tivh)):
        out.append(det.ImVoxelNetConfig(
            n_voxels=(16, 16, 8), voxel_size=(0.4, 0.4, 0.4),
            fpn_out_channels=16, neck=det.NeckConfig(**neck),
            head_kind='indoor', anchor_head=None,
            indoor_head=ivh.IndoorHeadConfig(**head),
            backbone_stage_blocks=(1, 1, 1, 1)))
    return tuple(out)


def tiny_sunrgbd_batch_np(b, seed=0):
    """The port's synthetic SUN RGB-D batch at 128x96, as numpy."""
    from imvoxelnet_tpu_torch.utils.synthetic import sunrgbd_batch

    return {k: v.numpy() for k, v in sunrgbd_batch(
        b, 'cpu', seed=seed, size=(128, 96)).items()}


def jax_neck(cfg):
    """The JAX package's 3D neck module for a JAX ``ImVoxelNetConfig``."""
    from imvoxelnet_tpu.models import necks3d

    n = cfg.neck
    if n.kind == 'kitti':
        return necks3d.KittiImVoxelNeck(n.in_channels, n.out_channels)
    if n.kind == 'imvoxel':
        return necks3d.ImVoxelNeck(n.channels, n.out_channels,
                                   n.down_layers, n.up_layers)
    return necks3d.FastIndoorImVoxelNeck(n.in_channels, n.n_blocks,
                                         n.out_channels)


def tiny_total3d_cfgs(fast=False):
    """:func:`tiny_indoor_cfgs` with Total3D's layout head (the presets'
    ``LayoutHeadConfig``) in both packages."""
    import dataclasses

    from imvoxelnet_tpu.models.heads import layout_head as jlh
    from imvoxelnet_tpu_torch.models.heads import layout_head as tlh

    return tuple(dataclasses.replace(c, layout_head=lh.LayoutHeadConfig())
                 for c, lh in zip(tiny_indoor_cfgs(fast=fast), (jlh, tlh)))


def tiny_scannet_cfgs(fast=False):
    """:func:`tiny_indoor_cfgs` with ScanNet's axis-aligned head (6
    regression outputs, no yaw) in both packages."""
    import dataclasses

    return tuple(dataclasses.replace(c, indoor_head=dataclasses.replace(
        c.indoor_head, dataset='scannet', n_reg_outs=6))
        for c in tiny_indoor_cfgs(fast=fast))


def recording(tx):
    """The optax transformation ``tx`` behind a stage that passes the
    gradients on unchanged and keeps them in its state (``opt_state[0]``):
    the JAX ``make_train_step``'s raw gradients, with no second compile."""
    import jax
    import jax.numpy as jnp
    import optax

    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))
    return optax.chain(keep, tx)


def tiny_nuscenes_cfgs():
    """The same tiny ``imvoxelnet_nuscenes`` config in both packages (JAX,
    port): ResNet stages (1, 1, 1, 1) with DCNv2 in stages 3-4, FPN 16,
    16x16x12 voxels of 1.6 x 1.6 x 0.32 m around the ego (nz 12, so that
    the nuScenes neck collapses z to 1 on an 8x8 map), the preset's head
    with anchors over that grid, ``nms_pre`` 64 and ``max_out`` 16."""
    import dataclasses

    from imvoxelnet_tpu.configs import presets as jax_presets
    from imvoxelnet_tpu_torch.configs import presets

    out = []
    for p in (jax_presets, presets):
        full = p.get_preset('imvoxelnet_nuscenes').model
        out.append(dataclasses.replace(
            full, n_voxels=(16, 16, 12), voxel_size=(1.6, 1.6, 0.32),
            fpn_out_channels=16, backbone_stage_blocks=(1, 1, 1, 1),
            neck=dataclasses.replace(full.neck, in_channels=16,
                                     out_channels=32),
            anchor_head=dataclasses.replace(
                full.anchor_head,
                anchor_ranges=((-12.8, -12.8, -1.0, 12.8 - 3.2, 12.8 - 3.2,
                                -1.0),),
                nms_pre=64, max_out=16)))
    return tuple(out)
