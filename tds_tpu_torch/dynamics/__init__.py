"""Featherstone dynamics on batched torch tensors (counterpart of
tds_tpu.dynamics): kinematics, ABA, CRBA, RNEA, Jacobians, integrators."""

from tds_tpu_torch.dynamics.forward_dynamics import forward_dynamics
from tds_tpu_torch.dynamics.integrator import integrate_euler, integrate_euler_qdd, integrate_q
from tds_tpu_torch.dynamics.kinematics import fk_links, forward_kinematics, forward_kinematics_q
