"""Print the resolved configuration of a preset, or list the presets.

    python -m imvoxelnet_tpu_torch.tools.print_config [PRESET] \\
        [--override PATH=VALUE]

Counterpart of the JAX package's ``tools/print_config.py``: without a
preset the names of all presets, one a line; with one its dataclasses as a
pretty-printed dict, after the overrides.
"""

from __future__ import annotations

import argparse
import dataclasses
import pprint

from ..configs.presets import PRESETS, apply_overrides, get_preset


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('preset', nargs='?', default=None)
    parser.add_argument('--override', action='append', default=None,
                        metavar='PATH=VALUE',
                        help='preset field override, e.g. '
                             'model.indoor_head.score_thr=0.1 (repeatable)')
    args = parser.parse_args(argv)
    if args.preset is None:
        print('\n'.join(sorted(PRESETS)))
        return sorted(PRESETS)
    preset = get_preset(args.preset)
    if args.override:
        preset = apply_overrides(preset, args.override)
    config = dataclasses.asdict(preset)
    pprint.pprint(config)
    return config


if __name__ == '__main__':
    main()
