"""Strip the training state from a checkpoint and append a content hash to
the file name.

    python -m imvoxelnet_tpu_torch.tools.publish_model latest.pth model.pth

Counterpart of the JAX package's ``tools/publish_model.py``: of the port's
train state (``tools/train.py``'s ``latest.pth``) only ``state_dict`` and
``meta`` are kept (the optimizer, schedule and step go), saved with
``torch.save`` as ``OUT-<sha256[:8]>.pth`` (``OUT-<sha256[:8]>`` for a name
without ``.pth``), the hash of the written bytes.  The result loads with
``--checkpoint`` and ``--torch-checkpoint`` alike.
"""

from __future__ import annotations

import argparse
import hashlib
import io

import torch


def publish(in_file: str, out_file: str) -> str:
    """Write the published checkpoint; returns its path."""
    payload = torch.load(in_file, map_location='cpu', weights_only=True)
    slim = {k: payload[k] for k in ('state_dict', 'meta') if k in payload}
    buf = io.BytesIO()
    torch.save(slim, buf)
    blob = buf.getvalue()
    sha = hashlib.sha256(blob).hexdigest()[:8]
    out = (out_file[:-4] + f'-{sha}.pth' if out_file.endswith('.pth')
           else out_file + f'-{sha}')
    with open(out, 'wb') as f:
        f.write(blob)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('in_file')
    parser.add_argument('out_file')
    args = parser.parse_args(argv)
    out = publish(args.in_file, args.out_file)
    print(f'published {out}')
    return out


if __name__ == '__main__':
    main()
