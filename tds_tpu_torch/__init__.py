"""tds_tpu_torch — the PyTorch/CUDA port of tds_tpu.

Featherstone dynamics, MLCP contact and the laikago locomotion env as plain
functions on batched torch tensors, with the projected Gauss-Seidel solve as
a hand-written CUDA kernel (``csrc/pgs.cu``) for tensors on the card. The
package imports ``torch`` and never ``jax`` or ``tds_tpu``; it reads URDF
assets from ``tds_tpu/data`` by path. Importing it builds nothing: a kernel
builds at its first CUDA launch.
"""
