"""The laikago control step fused into one kernel launch (K2): the kernel's
operands, its plain version and its wrapper.

- :func:`pack_step_params` writes out the kernel's operands, the model's
  constants, the schedule tables the kernel's lanes walk
  (:func:`link_schedule`, :func:`sphere_paths`) and the env's control and
  contact settings, as a :class:`StepParams` of contiguous tensors on the
  env's device;
- :func:`mega_step_reference` is the plain PyTorch version of the step,
  batched over envs, that reads only those operands;
- :func:`mega_step` launches the hand-written kernel ``csrc/megastep.cu`` on
  CUDA tensors and runs the plain version on CPU tensors; anything else
  raises, and no switch sends a CUDA tensor to the plain version;
- :func:`launch_shape` reports the kernel's lanes per env, envs per block,
  shared memory and resident warps per SM on the card.

It replaces the JAX package's ``tools/pallas_megastep_experiment.py``
kernel; ``python -m tds_tpu_torch.tools.megastep`` is the counterpart of
that experiment. The kernel is built with nvcc for sm_90a at its first
launch into ``build/kernels/megastep-<hash>/``
(``tds_tpu_torch.utils.cuda_build``) and loaded with ctypes. Importing this
module builds and runs nothing. ``launches`` counts the kernel launches; a
caller may reset it to 0.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from tds_tpu_torch.algebra import spatial
from tds_tpu_torch.algebra.inertia import ArticulatedBodyInertia, RigidBodyInertia
from tds_tpu_torch.algebra.transform import Transform
from tds_tpu_torch.contact import pgs
from tds_tpu_torch.contact.mlcp import check_params, plane_space
from tds_tpu_torch.model.geometry import Plane, Sphere
from tds_tpu_torch.model.joints import JointType, jcalc_transform, jcalc_velocity
from tds_tpu_torch.utils import cuda_build

# (links, DoF, contact spheres) of the template instances in csrc/megastep.cu,
# each in float32 and float64 with 16 lanes per env
INSTANCES = ((22, 18, 4),)
DTYPES = (torch.float32, torch.float64)
LANES_PER_ENV = 16

launches = 0


class StepParams(NamedTuple):
    """K2's operands: contiguous tensors on the env's device, in its dtype
    (the tables in int32), then two loop counts. The field order is the
    order of ``StepOperands`` in csrc/megastep.cu."""

    # topology; q, qd and tau share one layout (fixed base, 1-DoF joints)
    joint_types: torch.Tensor  # (NL,) model.joints.JointType values
    parents: torch.Tensor  # (NL,) -1 for the base
    q_offsets: torch.Tensor  # (NL,) -2 for fixed joints
    qd_offsets: torch.Tensor  # (NL,)
    pd_q: torch.Tensor  # (n_pd,) q slots of the PD joints, in pose-vector order
    # schedule tables (link_schedule, sphere_paths)
    chain: torch.Tensor  # (n_chain,) links from the root to the branch link
    subtrees: torch.Tensor  # (n_subtrees, 2) [start, end) of each chain hanging from the branch link
    sphere_paths: torch.Tensor  # (NC, P) each sphere's link and its ancestors to the root, -1 padded
    # model
    x_t_pos: torch.Tensor  # (NL, 3) joint frames in the parent link
    x_t_rot: torch.Tensor  # (NL, 3, 3)
    subspaces: torch.Tensor  # (NL, 6) motion subspaces
    mass: torch.Tensor  # (NL,)
    com: torch.Tensor  # (NL, 3) first moments m * com
    inertia: torch.Tensor  # (NL, 3, 3) about the link origin
    stiffness: torch.Tensor  # (NL,)
    damping: torch.Tensor  # (NL,)
    base_pos: torch.Tensor  # (3,) fixed-base placement in the world
    base_rot: torch.Tensor  # (3, 3)
    gravity: torch.Tensor  # (3,)
    # control
    kp: torch.Tensor  # ()
    kd: torch.Tensor  # ()
    max_force: torch.Tensor  # ()
    action_limit: torch.Tensor  # ()
    initial_poses: torch.Tensor  # (n_pd,)
    dt: torch.Tensor  # ()
    # contact: NC spheres on the robot against the ground plane
    sphere_links: torch.Tensor  # (NC,) int32
    sphere_offsets: torch.Tensor  # (NC, 3) centre in the link frame
    sphere_radii: torch.Tensor  # (NC,)
    plane_normal: torch.Tensor  # (3,) plane n.x = constant
    plane_constant: torch.Tensor  # ()
    friction: torch.Tensor  # (NC,) the pair's lesser friction
    restitution: torch.Tensor  # (NC,) the pair's greater restitution
    erp: torch.Tensor  # ()
    cfm: torch.Tensor  # ()
    pgs_iterations: int
    num_friction_dir: int


POINTER_FIELDS = StepParams._fields[:-2]


def link_schedule(parents):
    """(chain, subtrees) of a tree whose links are numbered parents first,
    link 0 the only root: the chain of links from the root down to the
    first link with more than one child (the branch link; the last link of
    a pure chain), and the [start, end) index range of each chain that
    hangs from the branch link. Each link lies in the chain or in one
    subtree. Raises NotImplementedError on any other tree (a subtree that
    branches again or skips an index), which the kernel's lanes cannot
    walk."""
    nl = len(parents)
    children = [[] for _ in range(nl)]
    for i, p in enumerate(parents):
        if p >= i or (p < 0) != (i == 0):
            raise NotImplementedError("the fused step needs links numbered parents first, link 0 the only root")
        if p >= 0:
            children[p].append(i)
    chain = [0]
    while len(children[chain[-1]]) == 1:
        chain.append(children[chain[-1]][0])
    subtrees = []
    for start in children[chain[-1]]:
        end = start + 1
        while children[end - 1] == [end]:
            end += 1
        if children[end - 1]:
            raise NotImplementedError(f"the subtree from link {start} is no chain of consecutive links, which the lanes walk")
        subtrees.append((start, end))
    if sorted(chain + [i for start, end in subtrees for i in range(start, end)]) != list(range(nl)):
        raise NotImplementedError("the chain and its subtrees do not cover the links")
    return chain, subtrees


def sphere_paths(parents, links):
    """For each sphere's link, the link and its ancestors up to the root,
    padded with -1 to the longest path."""
    paths = []
    for link in links:
        path, i = [], link
        while i >= 0:
            path.append(i)
            i = parents[i]
        paths.append(path)
    width = max(len(p) for p in paths)
    return [p + [-1] * (width - len(p)) for p in paths]


def pack_step_params(env) -> StepParams:
    """K2's operands for a ``LocomotionEnv`` (the counterpart of the
    experiment's closure conversion of the step's constants, written out).
    Raises NotImplementedError on what the kernel does not handle: floating
    bases, spherical joints, trees that :func:`link_schedule` refuses, geoms
    other than a ground plane against spheres on the robot's links, and the
    solver options that ``resolve_collision`` refuses (``top_k`` among
    them). A sphere's
    attachment rotation does not move its centre and is not packed."""
    model, world = env.model, env.world
    if model.is_floating:
        raise NotImplementedError("the fused step handles fixed bases only")
    if JointType.SPHERICAL in model.joint_types:
        raise NotImplementedError("the fused step handles fixed and 1-DoF joints only")
    ground, robot = world.geoms if len(world.geoms) == 2 else ((), ())
    if world.bodies[0].dof_qd != 0 or len(ground) != 1 or not isinstance(ground[0].shape, Plane):
        raise NotImplementedError("the fused step takes one static ground plane and one robot")
    if not robot or not all(isinstance(g.shape, Sphere) and g.link_index >= 0 for g in robot):
        raise NotImplementedError("the fused step collides spheres on the robot's links only")
    check_params(world.solver, len(robot))
    (plane,) = ground
    device, dtype = env.device, env.dtype
    chain, subtrees = link_schedule(model.parents)
    sphere_links = [g.link_index for g in robot]

    def table(values):
        return torch.tensor(values, dtype=torch.int32, device=device)

    def values(x):
        return torch.as_tensor(x, dtype=dtype, device=device).contiguous()

    return StepParams(
        joint_types=table(model.joint_types),
        parents=table(model.parents),
        q_offsets=table(model.q_offsets),
        qd_offsets=table(model.qd_offsets),
        pd_q=table(env.pd_q_indices()),
        chain=table(chain),
        subtrees=table(subtrees).reshape(len(subtrees), 2),
        sphere_paths=table(sphere_paths(model.parents, sphere_links)),
        x_t_pos=values(model.x_t_pos),
        x_t_rot=values(model.x_t_rot),
        subspaces=values(model.subspaces),
        mass=values(model.mass),
        com=values(model.com),
        inertia=values(model.inertia),
        stiffness=values(model.stiffness),
        damping=values(model.damping),
        base_pos=values(model.base_pos),
        base_rot=values(model.base_rot),
        gravity=values(env.gravity),
        kp=values(env.kp),
        kd=values(env.kd),
        max_force=values(env.max_force),
        action_limit=values(env.action_limit),
        initial_poses=values(env.initial_poses),
        dt=values(env.dt),
        sphere_links=table(sphere_links),
        sphere_offsets=values([g.pos for g in robot]),
        sphere_radii=values([g.shape.radius for g in robot]),
        plane_normal=values(plane.shape.normal),
        plane_constant=values(plane.shape.constant),
        friction=values([min(plane.friction, g.friction) for g in robot]),
        restitution=values([max(plane.restitution, g.restitution) for g in robot]),
        erp=values(world.solver.erp),
        cfm=values(world.solver.cfm),
        pgs_iterations=int(world.solver.pgs_iterations),
        num_friction_dir=int(world.solver.num_friction_dir),
    )


# -- the plain version ------------------------------------------------------
class _Tables(NamedTuple):
    joint_types: tuple
    parents: tuple
    q_offsets: tuple
    qd_offsets: tuple
    sphere_links: tuple
    order: tuple  # the chain, then each subtree: every link after its parent
    sphere_paths: tuple  # per sphere, its link and its ancestors to the root


def _tables(params: StepParams) -> _Tables:
    lists = [tuple(getattr(params, f).tolist()) for f in _Tables._fields[:5]]
    order = tuple(params.chain.tolist()) + tuple(i for start, end in params.subtrees.tolist() for i in range(start, end))
    paths = tuple(tuple(i for i in path if i >= 0) for path in params.sphere_paths.tolist())
    return _Tables(*lists, order, paths)


def _fk(params, tab, q, qd):
    """Forward kinematics over the packed tables: per link X_parent,
    X_world, v, c, p^A and the rigid-body inertia as articulated blocks."""
    s = params.subspaces
    base = Transform(params.base_pos, params.base_rot)
    zero_v = q.new_zeros(q.shape[:-1] + (6,))
    xp, xw, v, c, p_a, abi = ([None] * len(tab.order) for _ in range(6))
    for i in tab.order:
        jt, parent = JointType(tab.joint_types[i]), tab.parents[i]
        off, voff = tab.q_offsets[i], tab.qd_offsets[i]
        x_t = Transform(params.x_t_pos[i], params.x_t_rot[i])
        x = jcalc_transform(jt, x_t, s[i], q[..., off : off + 1])
        xw[i] = (xw[parent] if parent >= 0 else base).compose(x)
        inertia = ArticulatedBodyInertia.from_rbi(RigidBodyInertia(params.mass[i], params.com[i], params.inertia[i]))
        v_in = x.motion_to_child(v[parent]) if parent >= 0 else zero_v
        if jt == JointType.FIXED:
            vi, ci = v_in, torch.zeros_like(v_in)
        else:
            v_j = jcalc_velocity(jt, s[i], qd[..., voff : voff + 1])
            vi = v_in + v_j if parent >= 0 else v_j
            ci = spatial.cross_mm(vi, v_j)
        xp[i], v[i], c[i] = x, vi, ci
        p_a[i] = spatial.cross_mf(vi, inertia.mul_motion(vi))
        abi[i] = inertia
    return xp, xw, c, p_a, abi


def _factor(params, tab, xp, abi):
    """Backward articulated-inertia sweep: U, 1/D and I^a per link."""
    abi = list(abi)
    u, d_inv = [None] * len(abi), [None] * len(abi)
    for i in reversed(tab.order):
        s = params.subspaces[i]
        u[i] = abi[i].mul_motion(s)
        if tab.joint_types[i] == JointType.FIXED:
            d_inv[i] = torch.zeros_like(u[i][..., 0])
        else:
            d_inv[i] = 1.0 / spatial.dot(s, u[i])
            abi[i] = abi[i] - ArticulatedBodyInertia.outer_ff(u[i], u[i] * d_inv[i][..., None])
        parent = tab.parents[i]
        if parent >= 0:
            abi[parent] = abi[parent] + xp[i].abi_to_parent(abi[i])
    return u, d_inv, abi


def _forward_sweep(params, tab, xp, u, d_inv, u_bias, base_acc, c, dof):
    """Joint accelerations (..., dof) from the base acceleration, with the
    bias accelerations ``c`` (None for M^-1 x)."""
    a = [None] * len(xp)
    cols = [None] * dof
    for i in tab.order:
        parent = tab.parents[i]
        ai = xp[i].motion_to_child(a[parent] if parent >= 0 else base_acc)
        if c is not None:
            ai = ai + c[i]
        if tab.joint_types[i] != JointType.FIXED:
            x = d_inv[i] * (u_bias[i] - spatial.dot(u[i], ai))
            cols[tab.qd_offsets[i]] = x
            ai = ai + params.subspaces[i] * x[..., None]
        a[i] = ai
    return torch.stack(cols, dim=-1)


def _minv_mul(params, tab, xp, u, d_inv, x):
    """M(q)^-1 x for x (R, B, dof): the sweeps at zero velocity and
    gravity, a None force standing for zero."""
    nl = len(xp)
    p_a, u_bias = [None] * nl, [None] * nl
    for i in reversed(tab.order):
        pa = p_a[i]
        if tab.joint_types[i] != JointType.FIXED:
            x_l = x[..., tab.qd_offsets[i]]
            u_b = x_l if pa is None else x_l - spatial.dot(params.subspaces[i], pa)
            uud = u[i] * (u_b * d_inv[i])[..., None]
            pa = uud if pa is None else pa + uud
            u_bias[i] = u_b
        parent = tab.parents[i]
        if parent >= 0 and pa is not None:
            delta = xp[i].force_to_parent(pa)
            p_a[parent] = delta if p_a[parent] is None else p_a[parent] + delta
    return _forward_sweep(params, tab, xp, u, d_inv, u_bias, x.new_zeros(x.shape[:-1] + (6,)), None, x.shape[-1])


def _sphere_contacts(params, tab, xw, bsz):
    """Plane-sphere candidates: signed distances (B, NC) and the world
    points on the spheres nearest the plane (B, NC, 3)."""
    centre = torch.stack(
        [xw[link].apply_point(params.sphere_offsets[k]).expand(bsz, 3) for k, link in enumerate(tab.sphere_links)],
        dim=-2,
    )
    n = params.plane_normal
    distance = (centre * n).sum(-1) - params.plane_constant - params.sphere_radii
    return distance, centre - params.sphere_radii[:, None] * n


def sphere_distances(params: StepParams, q) -> torch.Tensor:
    """Signed distances (B, NC) of the contact spheres to the plane at
    positions q (B, dof); a row is active where its sphere's is negative."""
    tab = _tables(params)
    xw = _fk(params, tab, q, torch.zeros_like(q))[1]
    return _sphere_contacts(params, tab, xw, q.shape[0])[0]


def _point_jacobian(params, tab, xw, path, point, dof):
    """(B, 3, dof) Jacobian of the velocity of world ``point`` (B, 3) on
    the first link of ``path``, with columns along the path to the root."""
    cols = {}
    for i in path:
        if tab.joint_types[i] != JointType.FIXED:
            st = xw[i].motion_to_parent(params.subspaces[i])
            cols[tab.qd_offsets[i]] = st[..., 3:6] - spatial.cross(point, st[..., 0:3])
    zero = point.new_zeros(point.shape)
    return torch.stack([cols.get(k, zero) for k in range(dof)], dim=-1)


def mega_step_reference(params: StepParams, q, qd, action):
    """One control step on (B, dof), (B, dof), (B, n_pd) -> (q, qd), plain
    PyTorch, in the kernel's order: PD -> FK -> ABA factor -> bias and
    forward sweeps -> qd += qdd dt -> plane-sphere candidates -> point
    Jacobians -> contact rows J -> M^-1 J^T -> Delassus + cfm I -> PGS ->
    impulse -> q += qd dt. Reads only ``params``, walking the links in the
    order of its schedule tables (the chain, then each subtree; backward
    sweeps in reverse) and each sphere's Jacobian along its path
    (counterparts: tds_tpu/envs/locomotion.py sim_step,
    control/pd.py, dynamics/{kinematics,forward_dynamics,integrator,
    jacobian}.py, collision/narrowphase.py, contact/mlcp.py, world.py)."""
    tab = _tables(params)
    bsz, dof = qd.shape
    # PD on the compact pose vector; q, qd and tau share one layout
    slots = params.pd_q.long()
    targets = params.initial_poses + torch.clamp(action, -params.action_limit, params.action_limit)
    force = params.kp * (targets - q[:, slots]) + params.kd * (0.0 - qd[:, slots])
    tau = torch.zeros_like(qd).index_copy(-1, slots, torch.clamp(force, -params.max_force, params.max_force))

    xp, xw, c, p_a, abi = _fk(params, tab, q, qd)
    u, d_inv, ia = _factor(params, tab, xp, abi)
    p_a = list(p_a)
    u_bias = [None] * len(xp)
    for i in reversed(tab.order):
        pa = p_a[i] + ia[i].mul_motion(c[i])
        if tab.joint_types[i] != JointType.FIXED:
            off, voff = tab.q_offsets[i], tab.qd_offsets[i]
            tau_l = tau[:, voff] - params.stiffness[i] * q[:, off] - params.damping[i] * qd[:, voff]
            u_b = tau_l - spatial.dot(params.subspaces[i], p_a[i])
            pa = pa + u[i] * (u_b * d_inv[i])[..., None]
            u_bias[i] = u_b
        parent = tab.parents[i]
        if parent >= 0:
            p_a[parent] = p_a[parent] + xp[i].force_to_parent(pa)
    base_acc = torch.cat([torch.zeros_like(params.gravity), -params.gravity]).expand(bsz, 6)
    qdd = _forward_sweep(params, tab, xp, u, d_inv, u_bias, base_acc, c, dof)
    qd = qd + qdd * params.dt

    # contact: the ground (body a, no DoF) against the robot's spheres (body b)
    nc = len(tab.sphere_links)
    distance, point = _sphere_contacts(params, tab, xw, bsz)
    normal = (-params.plane_normal).expand(point.shape)
    collision = (distance < 0.0).to(q.dtype)
    jac = torch.stack([_point_jacobian(params, tab, xw, path, point[:, k], dof) for k, path in enumerate(tab.sphere_paths)], dim=-3)
    rel_vel = -(jac @ qd[:, None, :, None]).squeeze(-1)  # (B, NC, 3)
    vn = (normal * rel_vel).sum(-1)
    b_n = (-(1.0 + params.restitution) * vn - params.erp * distance / params.dt) * collision
    fr1, fr2 = plane_space(normal)
    col3 = collision[..., None]
    dirs = [normal * col3, fr1 * col3, fr2 * col3][: 1 + params.num_friction_dir]
    rhs = torch.cat([b_n] + [-(d * rel_vel).sum(-1) for d in dirs[1:]], dim=-1)
    rows = torch.cat([torch.einsum("bkdn,bkd->bkn", jac, d) for d in dirs], dim=-2)  # (B, R, dof)
    jminv = _minv_mul(params, tab, xp, u, d_inv, rows.movedim(-2, 0)).movedim(0, -2)
    n_rows = rows.shape[-2]
    a_mat = rows @ jminv.transpose(-1, -2) + params.cfm * torch.eye(n_rows, dtype=q.dtype, device=q.device)
    fric = params.friction.expand(bsz, nc)
    nfd = params.num_friction_dir
    lo = torch.cat([torch.zeros_like(fric)] + [-fric] * nfd, dim=-1)
    hi = torch.cat([torch.full_like(fric, 1e5)] + [fric] * nfd, dim=-1)
    dep = [-1] * nc + list(range(nc)) * nfd
    p = pgs.solve_pgs_reference(a_mat.contiguous(), rhs, lo, hi, dep, params.pgs_iterations)
    qd = qd - (p[:, None, :] @ jminv).squeeze(-2)
    return q + qd * params.dt, qd


# -- the kernel ---------------------------------------------------------------
class _Operands(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in POINTER_FIELDS] + [
        (name, ctypes.c_int)
        for name in ("pgs_iterations", "num_friction_dir", "num_chain", "num_subtrees", "path_length")
    ]


def operands(params: StepParams) -> _Operands:
    """The kernel's ``StepOperands``: the addresses of ``params``' tensors,
    its loop counts and the sizes of its schedule tables."""
    return _Operands(
        *(getattr(params, f).data_ptr() for f in POINTER_FIELDS),
        params.pgs_iterations, params.num_friction_dir, params.chain.numel(), params.subtrees.shape[0],
        params.sphere_paths.shape[1],
    )


def mega_step(params: StepParams, q, qd, action):
    """One control step on a batch: q, qd (B, dof), action (B, n_pd) ->
    (q, qd). The kernel on a CUDA device, the plain version on the CPU."""
    devices = {t.device for t in (q, qd, action, params.x_t_pos)}
    if len(devices) != 1:
        raise ValueError(f"mega_step operands lie on several devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return mega_step_reference(params, q, qd, action)
    if device.type != "cuda":
        raise ValueError(f"no mega_step implementation for device {device}")
    return _mega_step_cuda(params, q, qd, action)


def _check_instance(params, dof):
    dtype = params.x_t_pos.dtype
    if dtype not in DTYPES:
        raise TypeError(f"the fused step kernel takes float32 or float64, got {dtype}")
    shape = (params.joint_types.numel(), dof, params.sphere_links.numel())
    if shape not in INSTANCES or params.num_friction_dir != 2:
        raise ValueError(
            f"the fused step kernel is built for (links, dof, spheres) in {INSTANCES} with 2 friction "
            f"directions, got {shape} with {params.num_friction_dir}"
        )
    if max(1, params.subtrees.shape[0]) > LANES_PER_ENV or params.sphere_paths.shape[0] != shape[2]:
        raise ValueError(f"{params.subtrees.shape[0]} subtrees need a lane each of {LANES_PER_ENV}, and each sphere a path")
    return dtype, shape


def _mega_step_cuda(params, q, qd, action):
    global launches
    out = launch(_library(), params, q, qd, action)
    launches += 1
    return out


def launch(lib, params: StepParams, q, qd, action):
    """One launch of the kernel of ``lib`` (:func:`build`'s library, or
    another build of its source bound by :func:`bind`) on CUDA tensors; returns
    (q, qd). Counts nothing: :func:`mega_step` is the entry point."""
    if q.dim() != 2:
        raise ValueError(f"q must be (B, dof), got {tuple(q.shape)}")
    bsz, dof = q.shape
    dtype, shape = _check_instance(params, dof)
    n_pd = params.pd_q.numel()
    for name, t, expected in (("q", q, (bsz, dof)), ("qd", qd, (bsz, dof)), ("action", action, (bsz, n_pd))):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, the params are {dtype}")
        if tuple(t.shape) != expected:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {expected}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    q_out, qd_out = torch.empty_like(q), torch.empty_like(qd)
    if bsz == 0:
        return q_out, qd_out
    ops = operands(params)
    fn = lib.tds_megastep_f32 if dtype == torch.float32 else lib.tds_megastep_f64
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(
            ctypes.byref(ops), q.data_ptr(), qd.data_ptr(), action.data_ptr(), q_out.data_ptr(),
            qd_out.data_ptr(), bsz, *shape, n_pd, stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused step kernel launch failed with CUDA error {rc}")
    return q_out, qd_out


def launch_shape(params: StepParams, batch: int) -> dict:
    """How the kernel launches for ``params`` (on a CUDA device) at ``batch``
    envs: ``cuda_build.launch_shape``'s fields, resident warps per SM and
    waves among them."""
    dof = params.qd_offsets.max().item() + 1
    dtype, shape = _check_instance(params, dof)
    args = (int(dtype == torch.float64), *shape, params.subtrees.shape[0])
    return cuda_build.launch_shape(_library().tds_megastep_launch_shape, args, batch, params.x_t_pos.device)


def build():
    """Compile ``csrc/megastep.cu`` unless a build of these sources exists;
    returns the shared library's path (``build.log`` beside it)."""
    return cuda_build.build("megastep.cu")


@functools.lru_cache(maxsize=None)
def _library():
    return bind(ctypes.CDLL(str(build())))


def bind(lib):
    """Declares the C functions of a library built from csrc/megastep.cu."""
    for fn in (lib.tds_megastep_f32, lib.tds_megastep_f64):
        fn.argtypes = [ctypes.POINTER(_Operands)] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.tds_megastep_launch_shape.argtypes = [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_int)]
    lib.tds_megastep_launch_shape.restype = ctypes.c_int
    return lib
