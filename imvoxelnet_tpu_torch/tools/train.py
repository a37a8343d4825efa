"""Train a preset from image files on one card or several processes, with
per-epoch validation and auto-resume.

    python -m imvoxelnet_tpu_torch.tools.train PRESET --data-root R \\
        --ann-file A [--work-dir W] [--epochs N] [--batch-size B] \\
        [--val-ann-file V] [--resume-from X.pth] [--override PATH=VALUE] \\
        [--ckpt-format pickle|orbax] [--device cuda]
    torchrun --nproc-per-node N -m imvoxelnet_tpu_torch.tools.train \\
        PRESET ... --multihost

Counterpart of the JAX package's ``tools/train.py``: info file +
image files -> train-mode dataset (augmentation seeded by ``--seed`` and
the epoch) -> loader threads -> ``data/loader.py:device_prefetch`` (batch
N+1 copied on a side stream while step N runs) -> the step of
``parallel/train.py`` (AdamW, joint clip, step LR from the preset) ->
``work_dir/latest.pth`` after every epoch (``utils/checkpoint.py``) ->
validation every ``--val-interval`` epochs through ``eval/runner.py`` and
the dataset's protocol.  A run resumes from ``latest.pth`` in its work dir,
or from ``--resume-from``, at the epoch the checkpoint records; a
``--resume-from`` file that holds weights alone (a reference ``.pth``) is a
start from those weights.

Log lines go to stdout and ``work_dir/train_log.jsonl`` with the JAX CLI's
keys.  The losses are read on the host only at a log line: between two log
lines the loop makes no host read and no stream sync.  ``data_time`` is the
time a step waited for its batch (queue-wait: 0 when the loader keeps up),
not the pipeline's own time.  TensorBoard scalars are written to
``work_dir/tb`` where ``torch.utils.tensorboard`` imports.

``--multihost`` joins the process group that torchrun's environment
describes (``parallel/mesh.py:init_distributed``: each process on
``cuda:LOCAL_RANK``, NCCL, or gloo where ranks share a card) and trains
with the JAX package's GSPMD semantics (``parallel/mesh.py``): the global
batch is ``samples_per_device`` x the world size (or ``--batch-size``),
every rank walks the same seeded order and loads its slice of each global
batch, the batch norms and loss normalizers are global and the gradients
are averaged before the one clip; indoor presets normalize by the global
batch's mean positive count (``dp_loss_norm='batch_mean'``) unless
``--override`` sets it; ``--autoscale-lr`` scales the LR by the world size
over the reference's 8 GPUs.  Only rank 0 writes the log, TensorBoard and
validation.  ``--ckpt-format`` keeps the JAX flag's values: ``pickle``
writes ``work_dir/latest.pth`` (one ``torch.save`` file, from rank 0),
``orbax`` writes ``work_dir/latest.dcp/``, a ``torch.distributed.checkpoint``
directory to which every rank writes its share (``utils/checkpoint.py:
save_checkpoint_sharded``); a run resumes from either.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from ..configs.presets import apply_overrides, get_preset
from ..data.datasets import DATASETS
from ..data.loader import DataLoader, device_prefetch
from ..data.pipeline import ImagePipelineConfig
from ..eval import runner
from ..models.detector import build_model
from ..parallel import mesh
from ..parallel import train as train_lib
from ..utils import checkpoint as ckpt_lib
from ..utils.precision import compute_precision

# the reference's runs train on 8 GPUs (tools/train.py:93-95: lr * n / 8)
REFERENCE_GPUS = 8


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('preset')
    parser.add_argument('--data-root', required=True)
    parser.add_argument('--ann-file', required=True)
    parser.add_argument('--work-dir', default='work_dirs/default')
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--batch-size', type=int, default=None,
                        help='the global batch (default: the preset\'s '
                             'samples per device x the world size)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--resume-from', default=None,
                        help='a train state (latest.pth), or a .pth of '
                             'weights alone to start from')
    parser.add_argument('--num-workers', type=int, default=8)
    parser.add_argument('--log-interval', type=int, default=50)
    parser.add_argument('--val-ann-file', default=None,
                        help='validate on this split every --val-interval '
                             'epochs')
    parser.add_argument('--val-data-root', default=None,
                        help='default: --data-root')
    parser.add_argument('--val-interval', type=int, default=1)
    parser.add_argument('--val-batch-size', type=int, default=1)
    parser.add_argument('--override', action='append', default=None,
                        metavar='PATH=VALUE',
                        help='preset field override, e.g. '
                             'model.compute_dtype=bfloat16 (repeatable)')
    parser.add_argument('--autoscale-lr', action='store_true',
                        help='scale the LR by the world size / the '
                             'reference\'s 8 GPUs')
    parser.add_argument('--multihost', action='store_true',
                        help='join the process group of torchrun\'s '
                             'environment, one process a card')
    parser.add_argument('--ckpt-format', choices=('pickle', 'orbax'),
                        default='pickle',
                        help='pickle: work_dir/latest.pth from rank 0; '
                             'orbax: work_dir/latest.dcp/, a '
                             'torch.distributed.checkpoint directory every '
                             'rank writes its share of')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def build_train_dataset(preset, data_root, ann_file):
    """The preset's train-mode dataset (the JAX CLI's :109-114): train
    scales, padding and flips of the preset, its views and repeats; a
    layout-head preset reads the Total3D schema."""
    d = preset.data
    img_cfg = ImagePipelineConfig(
        test_scale=d.test_size, pad_size=(d.test_size[1], d.test_size[0]),
        train_pad_size=(d.train_size[1], d.train_size[0]),
        flip_ratio=d.flip_ratio, fixed_size_resize=(d.dataset == 'scannet'),
        train_scales=d.train_scales)
    ds_key = d.dataset
    if preset.model.layout_head is not None:
        ds_key = 'sunrgbd_total'
    return DATASETS[ds_key](data_root, ann_file, d.classes, img_cfg,
                            n_images=d.n_images_train, max_gt=d.max_gt,
                            repeat=d.repeat_times)


class _Log:
    """Each line to stdout, ``train_log.jsonl`` and, where it imports,
    TensorBoard."""

    def __init__(self, work_dir):
        self.path = os.path.join(work_dir, 'train_log.jsonl')
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self.tb = SummaryWriter(os.path.join(work_dir, 'tb'))

    def line(self, line, scalars, prefix):
        print(json.dumps(line), flush=True)
        with open(self.path, 'a') as f:
            f.write(json.dumps(line) + '\n')
        if self.tb is not None:
            for key, value in scalars.items():
                self.tb.add_scalar(f'{prefix}/{key}', value, line['step'])

    def close(self):
        if self.tb is not None:
            self.tb.close()


def main(argv=None):
    """Train; returns a summary: the ``train`` and ``val`` log lines, each
    epoch run (``epochs``: epoch, steps, ``seconds`` of its loop to the
    last step done on the card), ``start_epoch``, ``steps_per_epoch``, the
    final ``step``, the ``latest`` checkpoint's path, and ``rank`` and
    ``world`` (the lines are rank 0's; another rank logs none)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    rank, world = 0, 1
    if args.multihost:
        rank, world, device = mesh.init_distributed(device.type)
    say = print if rank == 0 else (lambda *a, **k: None)
    preset = get_preset(args.preset)
    if args.override:
        preset = apply_overrides(preset, args.override)
    if args.autoscale_lr:
        # linear LR scaling relative to the reference's 8-GPU runs
        preset = dataclasses.replace(preset,
                                     lr=preset.lr * world / REFERENCE_GPUS)
        say(f'autoscale-lr: lr={preset.lr} ({world} card'
            f'{"s" if world > 1 else ""} / {REFERENCE_GPUS})')
    cfg, d = preset.model, preset.data
    overrode_norm = any('dp_loss_norm' in o for o in args.override or [])
    if world > 1 and cfg.head_kind == 'indoor' and not overrode_norm:
        # the JAX CLI's switch (docs/parity.md, "DP training semantics")
        cfg = dataclasses.replace(cfg, dp_loss_norm='batch_mean')
        preset = dataclasses.replace(preset, model=cfg)
        say('dp_loss_norm=batch_mean (indoor training over several ranks)')
    os.makedirs(args.work_dir, exist_ok=True)
    batch_size = args.batch_size or d.samples_per_device * world
    epochs = args.epochs or preset.total_epochs

    dataset = build_train_dataset(preset, args.data_root, args.ann_file)
    loader = DataLoader(
        dataset, batch_size, train=True, seed=args.seed,
        num_workers=args.num_workers,
        images_dtype=(torch.bfloat16 if cfg.compute_dtype == 'bfloat16'
                      else None),
        pin_memory=device.type == 'cuda', world_size=world, rank=rank)
    steps_per_epoch = len(loader)
    say(f'dataset: {len(dataset)} samples, {steps_per_epoch} steps/epoch, '
        f'batch {batch_size} on {device}' +
        (f' and {world - 1} more rank(s)' if world > 1 else ''))

    model = build_model(cfg, device='cpu', seed=args.seed).to(device)
    optimizer, scheduler = train_lib.make_optimizer(
        model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
        preset.grad_clip_norm, steps_per_epoch, preset.lr_steps)

    start_epoch = step = 0
    latest = os.path.join(args.work_dir, 'latest.dcp' if args.ckpt_format
                          == 'orbax' else 'latest.pth')
    resume = args.resume_from or (latest if os.path.exists(latest) else None)
    if resume and os.path.isdir(resume):
        step, meta = ckpt_lib.load_checkpoint_sharded(resume, model,
                                                      optimizer, scheduler)
        start_epoch = meta.get('epoch', 0)
        say(f'resumed from {resume} at epoch {start_epoch}')
    elif resume:
        payload = ckpt_lib.load_checkpoint(resume)
        if 'optimizer' in payload:
            ckpt_lib.restore_train_state(
                model, optimizer, scheduler, payload['state_dict'],
                payload['optimizer'], payload['scheduler']['last_epoch'])
            start_epoch = payload['meta'].get('epoch', 0)
            step = payload['step']
            say(f'resumed from {resume} at epoch {start_epoch}')
        else:
            model.load_state_dict(ckpt_lib.load_reference_state_dict(resume),
                                  strict=True)
            say(f'weights from {resume}')
    step_fn = train_lib.make_train_step(model, optimizer, scheduler)

    log = _Log(args.work_dir) if rank == 0 else None
    val_dataset = val_loader = None
    if args.val_ann_file and rank == 0:
        val_dataset, val_loader = runner.build_val_dataset(
            preset, args.preset, args.val_data_root or args.data_root,
            args.val_ann_file, num_workers=args.num_workers,
            batch_size=args.val_batch_size, device=device)
        say(f'validation: {len(val_dataset)} samples every '
            f'{args.val_interval} epoch(s)')

    summary = dict(train=[], val=[], epochs=[], start_epoch=start_epoch,
                   steps_per_epoch=steps_per_epoch, latest=latest, rank=rank,
                   world=world)
    for epoch in range(start_epoch, epochs):
        t_data = t_step = 0.0
        t_epoch = t0 = time.perf_counter()
        for it, batch in enumerate(device_prefetch(loader.epoch(epoch),
                                                   device)):
            t1 = time.perf_counter()
            t_data += t1 - t0
            metrics = step_fn(batch)
            step += 1
            if (it + 1) % args.log_interval == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                t_step += time.perf_counter() - t1
                line = dict(epoch=epoch, iter=it + 1, step=step,
                            data_time=t_data / args.log_interval,
                            time=(t_data + t_step) / args.log_interval,
                            **metrics)
                if log is not None:
                    log.line(line, metrics, 'train')
                    summary['train'].append(line)
                t_data = t_step = 0.0
            else:
                t_step += time.perf_counter() - t1
            t0 = time.perf_counter()
        if device.type == 'cuda':
            torch.cuda.synchronize(device)
        summary['epochs'].append(dict(epoch=epoch + 1, steps=steps_per_epoch,
                                      seconds=time.perf_counter() - t_epoch))

        meta = dict(preset=args.preset, classes=list(d.classes),
                    epoch=epoch + 1)
        if args.ckpt_format == 'orbax':
            ckpt_lib.save_checkpoint_sharded(latest, model, optimizer,
                                             scheduler, step, meta)
        elif rank == 0:
            ckpt_lib.save_checkpoint(latest, model, optimizer, scheduler,
                                     step, meta)
        say(f'epoch {epoch + 1}/{epochs} done; checkpoint saved')
        if val_loader is not None and (epoch + 1) % args.val_interval == 0:
            # eval-mode batch norms; the next step puts the model back in
            # train mode
            model.eval()
            with compute_precision(cfg.compute_dtype):
                results = runner.run_inference(
                    model, cfg, val_loader, len(val_dataset.data_infos),
                    device)
                metrics = runner.evaluate_results(
                    preset, args.preset, val_dataset, results, device=device)
            metrics = {k: float(v) for k, v in metrics.items()}
            line = dict(mode='val', epoch=epoch + 1, step=step, **metrics)
            log.line(line, metrics, 'val')
            summary['val'].append(line)
        if world > 1:
            # the other ranks wait for rank 0's checkpoint and validation
            torch.distributed.barrier()
    if log is not None:
        log.close()
    if args.multihost:
        torch.distributed.destroy_process_group()
    summary['step'] = step
    return summary


if __name__ == '__main__':
    main()
