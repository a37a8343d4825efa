"""The benchmark of ``imvoxelnet_tpu_torch`` on one H100: see
``portbench/run.py``."""
