"""ImVoxelNet in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The port of ``imvoxelnet_tpu`` (JAX on TPU).  It mirrors that package's module
paths and keeps its public layouts, and imports nothing from it: the JAX
package is the reference the port is tested against.

The port covers the KITTI monocular forward (``simple_test``: backbone ->
FPN -> backprojection -> 3D neck -> anchor head -> decode + rotated NMS) and
training step, and the SUN RGB-D forward (multi-scale 3D necks, the indoor
head, decode + per-class rotated NMS).
Entry points run on ``cuda`` unless the caller passes a CPU device; on CPU
tensors the ops run each kernel's plain PyTorch version instead.
"""
