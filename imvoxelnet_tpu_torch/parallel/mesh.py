"""Data parallelism over processes, with the JAX package's GSPMD semantics.

Counterpart of ``imvoxelnet_tpu/parallel/mesh.py``.  The JAX package trains
as ONE program over the global batch, sharded over a ``data`` mesh axis
(``docs/parity.md``, "DP training semantics"); ``view_sharded_forward``
splits a scan's views over the mesh instead.  Here each process (rank) holds
the whole model and its slice of the global batch, and every place where
that one program differs from W independent ones takes a collective over
the default process group, so that a W-rank step equals one process on the
global batch:

- the 3D necks' and heads' batch norms normalise with the global batch's
  statistics (``models/layers.py:BatchNorm3d``);
- the KITTI losses are normalised by the global positive count
  (``models/heads/anchor3d_head.py:anchor3d_head_loss``), the indoor ones
  under ``dp_loss_norm='batch_mean'`` by the global mean count
  (``models/heads/imvoxel_heads.py:indoor_head_loss``);
- the gradients are averaged before the one joint clip
  (:func:`average_gradients`, ``parallel/train.py``);
- a view-sharded forward sums the backprojection's per-voxel feature sums
  and view counts over the ranks (``models/detector.py``).

Each rank's loss is scaled so that the mean of the ranks' gradients is the
gradient of the global-batch loss: its share of the global loss times W.
At world size 1, or with no process group, none of this runs and every
path is the one-card code.  Nothing here starts a process group at import.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import time

import torch
import torch.distributed as dist

# the largest bucket of the gradient all-reduce (DDP's is 25 MB)
BUCKET_BYTES = 64 << 20


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def init_distributed(device_type: str = 'cuda', timeout_s: float = 600.0):
    """Join the process group that torchrun's environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``); returns ``(rank, world_size,
    device)``.

    On the card each process takes ``cuda:LOCAL_RANK`` (modulo the cards
    there are) and the group runs NCCL; where several ranks share one card
    it runs gloo, since NCCL refuses two ranks on one device.  On the CPU
    the group runs gloo."""
    rank_, world = int(os.environ['RANK']), int(os.environ['WORLD_SIZE'])
    local = int(os.environ.get('LOCAL_RANK', 0))
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    if device_type == 'cuda':
        n_cards = torch.cuda.device_count()
        device = torch.device('cuda', local % n_cards)
        torch.cuda.set_device(device)
        backend = 'nccl' if local_world <= n_cards else 'gloo'
    else:
        device, backend = torch.device('cpu'), 'gloo'
    dist.init_process_group(
        backend, init_method='env://', rank=rank_, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank_, world, device


def batch_slice(global_batch: int, world: int = None,
                rank_: int = None) -> slice:
    """The rows of a global batch that a rank owns: the global batch split
    in W equal, contiguous parts (it must divide by W, as the JAX package's
    data-sharded arrays must)."""
    world = world_size() if world is None else world
    rank_ = rank() if rank_ is None else rank_
    if global_batch % world:
        raise ValueError(f'global batch {global_batch} does not divide by '
                         f'the world size {world}')
    per = global_batch // world
    return slice(rank_ * per, (rank_ + 1) * per)


def shard_batch(batch: dict, world: int = None, rank_: int = None) -> dict:
    """This rank's rows of every tensor of a global batch."""
    n = next(iter(batch.values())).shape[0]
    rows = batch_slice(n, world, rank_)
    return {k: v[rows] for k, v in batch.items()}


VIEW_KEYS = ('images', 'extrinsics')


def shard_views(batch: dict, world: int = None, rank_: int = None) -> dict:
    """This rank's views of a batch (the JAX ``view_sharded_forward``'s
    ``P(None, axis)`` on ``images`` and ``extrinsics``); the other keys
    whole."""
    return {k: (v[:, batch_slice(v.shape[1], world, rank_)]
                if k in VIEW_KEYS else v) for k, v in batch.items()}


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, differentiable: the gradient of a rank's
    input is the sum of the ranks' output gradients (each rank's loss is a
    term of one global loss)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks (a new tensor), through autograd.

    Where no gradient is recorded (serving) it is the functional
    collective, which ``torch.export`` traces to ``_c10d_functional.
    all_reduce`` + ``wait_tensor`` nodes of the default group: an exported
    view-sharded program pools its views that way on every rank."""
    if not torch.is_grad_enabled():
        from torch.distributed import _functional_collectives as fc
        return fc.all_reduce(x, 'sum', dist.group.WORLD)
    return _AllReduceSum.apply(x)


@torch.no_grad()
def mean_over_ranks(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ranks, outside autograd (the logged
    losses)."""
    y = x.detach().clone()
    dist.all_reduce(y)
    return y / world_size()


@torch.no_grad()
def average_gradients(params) -> None:
    """Average the ``.grad`` of ``params`` over the ranks, in place: the
    gradients are packed into flat buckets of at most ``BUCKET_BYTES`` per
    device and dtype, each all-reduced (sum) once and divided by W.  With
    one rank it does nothing."""
    world = world_size()
    if world == 1:
        return
    groups = {}
    for p in params:
        if p.grad is not None:
            groups.setdefault((p.grad.device, p.grad.dtype), []).append(
                p.grad)
    buckets = []
    for grads in groups.values():
        buckets.append([])
        size = 0
        for g in grads:
            n = g.numel() * g.element_size()
            if buckets[-1] and size + n > BUCKET_BYTES:
                buckets.append([])
                size = 0
            buckets[-1].append(g)
            size += n
    for bucket in buckets:
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat)
        flat.div_(world)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def view_sharded_forward(model):
    """``forward(batch, **kwargs)`` with the batch's VIEW axis split over
    the ranks (the JAX ``parallel/mesh.py:view_sharded_forward``, the
    sequence-parallel analog for the 50-view ScanNet test): each rank runs
    the backbone, the FPN and the backprojection on its views, the
    per-voxel (sum, count) pair is summed over the ranks, and the 3D neck
    and the head run replicated on the pooled volume.  ``batch`` is the
    whole batch on every rank; the view count must divide by W.

    The model's config must set ``view_shard_axis`` (e.g.
    ``dataclasses.replace(preset.model, view_shard_axis='view')``)."""
    if model.cfg.view_shard_axis is None:
        raise ValueError('set ImVoxelNetConfig.view_shard_axis to run '
                         'view-sharded')

    def forward(batch, **kwargs):
        return model(shard_views(batch), **kwargs)
    return forward


def free_ports(n: int) -> list:
    """``n`` distinct free ports of this host, held open together while
    they are picked (ranks started together once shared a port picked
    alone)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for sock in socks:
            sock.bind(('localhost', 0))
        return [sock.getsockname()[1] for sock in socks]
    finally:
        for sock in socks:
            sock.close()


def free_port() -> int:
    return free_ports(1)[0]


def start_ranks(cmd, world: int, port: int = 0, cwd=None, **env):
    """Start ``world`` processes of ``cmd`` on this host with torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``: ``port`` or
    a free one) and ``env``, their output captured: the launcher of the
    tools and tests that run several ranks."""
    port = port or free_port()
    return [subprocess.Popen(
        cmd, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=dict(
            os.environ, RANK=str(r), WORLD_SIZE=str(world),
            LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
            MASTER_ADDR='localhost', MASTER_PORT=str(port), **env))
        for r in range(world)]


def wait_ranks(procs, timeout: float):
    """The output of each process :func:`start_ranks` started.  Raises
    ``RuntimeError`` with the output of every rank that failed or outlived
    ``timeout`` seconds (all of them are killed then)."""
    deadline, outs, bad = time.monotonic() + timeout, [], []
    for r, proc in enumerate(procs):
        try:
            outs.append(proc.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            outs.append(proc.communicate()[0])
            bad.append(r)
            continue
        if proc.returncode:
            bad.append(r)
    if bad:
        raise RuntimeError(f'ranks {bad} failed or outlived {timeout} s\n'
                           + '\n'.join(f'--- rank {r}:\n{outs[r][-3000:]}'
                                        for r in bad))
    return outs
