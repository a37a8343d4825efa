"""What the port's measurement tools share: the card's name and power
limit, CUDA-event timing, and the H100's published peaks.

Every time these tools print is the card's, taken with CUDA events or a
host clock around work that ends in a synchronize; a tool that finds no
card stops (:func:`require_cuda`) instead of timing the CPU.
"""

from __future__ import annotations

import subprocess
import sys

import torch

# Published dense peaks of one H100 SXM (NVIDIA data sheet, 700 W): bytes
# per second of HBM3, operations per second of the tensor cores (bfloat16)
# and of the CUDA cores (float32, no TF32).
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def require_cuda(tool: str):
    """Exit with an error unless a card is visible: the tools measure the
    card and do not fall back to the CPU."""
    if not torch.cuda.is_available():
        sys.exit(f'{tool}: no CUDA device (the tool measures the card)')


def card() -> str:
    """``name, power.limit`` of the first card, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1, queue_us: float = 0) -> float:
    """Milliseconds per call of ``fn`` between two CUDA events around
    ``reps`` calls, after ``warmup`` calls.  ``queue_us`` (the host's cost
    per call, generously) first holds the device in a spin kernel while the
    host queues the calls, so that a kernel of microseconds is timed and
    not its launches."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queue_us:
        torch.cuda._sleep(int(reps * queue_us * 2000))   # ~2 cycles a ns
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps

