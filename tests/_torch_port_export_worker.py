"""One rank of ``tests/test_torch_port_tools_export.py``'s sharded tool
runs: ``tools/export.py``'s ``main`` once for each run, one after another
in this process (an interpreter's start-up and imports paid once), each on
a port of its own (not collected by pytest).

    python tests/_torch_port_export_worker.py PORT1,PORT2 RUNS_JSON

with torchrun's environment but ``MASTER_PORT``; ``RUNS_JSON`` is a list of
argument lists.  Rank 0 prints each run's JSON line.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from imvoxelnet_tpu_torch.tools import export as export_tool  # noqa: E402


def main(ports, runs):
    for port, argv in zip(ports.split(','), json.loads(runs)):
        os.environ['MASTER_PORT'] = port
        export_tool.main(argv)


if __name__ == '__main__':
    main(*sys.argv[1:])
