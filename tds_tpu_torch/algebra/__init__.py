"""Spatial algebra on batched torch tensors (counterpart of tds_tpu.algebra).

``smallmat`` and ``update`` of the JAX package work around TPU limits and
have no counterpart: their call sites are ``@``/``torch.einsum`` and
out-of-place writes here.
"""

from tds_tpu_torch.algebra import quaternion, rotation, spatial
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia, RigidBodyInertia
from tds_tpu_torch.algebra.transform import Transform
