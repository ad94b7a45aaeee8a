"""tds_tpu_torch — the PyTorch/CUDA port of tds_tpu.

Featherstone dynamics, MLCP contact and the laikago locomotion env as plain
functions on batched torch tensors, with the projected Gauss-Seidel solve as
a hand-written CUDA kernel (``csrc/pgs.cu``) for tensors on the card. The
package imports ``torch`` and never ``jax`` or ``tds_tpu``; it reads URDF
assets from ``tds_tpu/data`` by path. Importing it builds nothing: a kernel
builds at its first CUDA launch.
"""

from tds_tpu_torch import algebra
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia, RigidBodyInertia
from tds_tpu_torch.algebra.transform import Transform
from tds_tpu_torch.dynamics import forward_dynamics, forward_kinematics, integrate_euler, integrate_euler_qdd
from tds_tpu_torch.dynamics.inverse_dynamics import inverse_dynamics
from tds_tpu_torch.dynamics.jacobian import point_jacobian
from tds_tpu_torch.dynamics.mass_matrix import mass_matrix
from tds_tpu_torch.model.geometry import Box, Capsule, Cylinder, GeomAttachment, Heightfield, Mesh, Plane, Sphere
from tds_tpu_torch.model.joints import JointType
from tds_tpu_torch.model.multibody import MultiBodyBuilder, MultiBodyModel, MultiBodyState
from tds_tpu_torch.urdf.cache import construct as load_urdf
from tds_tpu_torch.world import World, build_world, make_ground_plane, world_step
