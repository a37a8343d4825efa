"""The plain PyTorch reference that decides ``correct``: a frozen copy of
the port's plain model code, imports nothing of ``imvoxelnet_tpu_torch``
and takes nothing the program made."""
