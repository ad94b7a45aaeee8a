"""Gradients through laikago's MLCP contact rollout, the port's counterpart
of the JAX package's ``tests/test_contact_gradients.py``.

    python -m tds_tpu_torch.tools.contact_loss [--steps 500] [--device cpu]

The loss is that test's: a PD-held laikago started 3 cm above its standing
height (z = 0.47) with a forward slide of 0.8 m/s, ``steps`` MLCP contact
steps, and the loss the base's final x plus its mean height. It is a
function of the PD gain ``kp``, a density scale of one link (its mass,
first moment and inertia together) and the ground's friction coefficient
under ``friction_mode="world_default"``. The rollout is one
``graphs.scan``: replayed CUDA graphs on the card, whose backward replays
the step's VJP graph (K1's backward kernel inside), the Python loop on the
CPU. Under ``torch.func.jacfwd`` (:func:`jacobian`) the scan replays a JVP
graph of the step instead. The command prints the gradient, central
differences of the same loss (the test's eps) and the seconds each took,
in float64.
"""

import argparse
import dataclasses
import time

import torch

from tds_tpu_torch.control.pd import pd_tau
from tds_tpu_torch.dynamics.forward_dynamics import aba_factor, forward_dynamics_from_kin
from tds_tpu_torch.dynamics.integrator import integrate_euler_qdd, integrate_q
from tds_tpu_torch.dynamics.kinematics import fk_links
from tds_tpu_torch.utils.graphs import scan
from tds_tpu_torch.utils.tensors import constant
from tds_tpu_torch.world import resolve_contacts

# the test's point and its central-difference steps for (kp, mass scale, friction)
POINT = (100.0, 1.0, 0.5)
FD_EPS = (1e-3, 1e-5, 1e-5)


def sliding_start(env, batch: int = 1, height: float = 0.47):
    """(q0, qd0, link): the test's start, standing joints with the base at
    z = ``height`` (0.47, 3 cm above standing; 0.44 touches down at the
    first step) and x velocity 0.8, and the first link with real mass (past
    the massless base-emulation chain)."""
    q0 = env.model.zero_q((batch,))
    q0[:, list(env.pd_q_indices())] = env.initial_poses
    q0[:, 2] = height
    qd0 = env.model.zero_qd((batch,))
    qd0[:, 0] = 0.8
    link = int(torch.nonzero(env.model.mass > 1e-6)[0, 0])
    return q0, qd0, link


def make_loss(env, q0, qd0, link: int, steps: int):
    """``loss(kp, mscale, friction)`` -> the summed loss over the batch
    (0-dim tensors in, a 0-dim tensor out), differentiable in all three."""
    model0 = env.model
    mask = tuple(i == link for i in range(model0.num_links))

    def step(carry, consts):
        q, qd, heights = carry
        kp, mscale, friction = consts
        s = torch.where(constant(mask, torch.bool, q.device), mscale, 1.0)
        model = dataclasses.replace(
            model0, mass=model0.mass * s, com=model0.com * s[:, None], inertia=model0.inertia * s[:, None, None]
        )
        world = dataclasses.replace(
            env.world,
            bodies=(env.world.bodies[0], model),
            solver=env.world.solver._replace(friction=friction),
            friction_mode="world_default",
        )
        tau = pd_tau(model, q, qd, env.initial_poses, kp, env.kd, env.max_force, skip_links=env.skip_links)
        kin = fk_links(model, q, qd)
        factor = aba_factor(model, kin)
        qdd = forward_dynamics_from_kin(model, kin, q, qd, tau, env.gravity, factor=factor)
        qd = integrate_euler_qdd(model, q, qd, qdd, env.dt)
        zero = q.new_zeros(q.shape[:-1] + (0,))
        qds = resolve_contacts(world, (zero, q), (zero, qd), env.dt, kins=[None, kin], factors=[None, factor])
        q, qd = integrate_q(model, q, qds[1], env.dt)
        return q, qd, heights + q[..., 2]

    def loss(kp, mscale, friction):
        carry = (q0, qd0, q0.new_zeros(q0.shape[:-1]))
        q, _, heights = scan(step, carry, (kp, mscale, friction), steps, key=("contact_loss", env, link))
        # slide distance + mean stance height: sensitive to friction, kp, mass
        return (q[..., 0] + heights / steps).sum()

    return loss


def gradient(loss, point, dtype, device):
    """(loss, d loss / d (kp, mscale, friction)) at ``point``."""
    args = [torch.tensor(v, dtype=dtype, device=device, requires_grad=True) for v in point]
    with torch.enable_grad():
        value = loss(*args)
        grads = torch.autograd.grad(value, args)
    return value.detach(), torch.stack(grads)


def jacobian(loss, point, dtype, device, forward: bool = True):
    """d loss / d (kp, mscale, friction) at ``point`` by ``torch.func.jacfwd``
    (forward mode: on the card one JVP graph of three tangents, K1's JVP
    kernel inside) or, with ``forward`` False, ``torch.func.jacrev``."""
    transform = torch.func.jacfwd if forward else torch.func.jacrev
    return transform(lambda p: loss(*p.unbind()))(torch.tensor(point, dtype=dtype, device=device))


def central_differences(loss, point, eps, dtype, device):
    """(f(x + eps) - f(x - eps)) / (2 eps) in each argument, no grad."""
    out = []
    with torch.no_grad():
        for k, e in enumerate(eps):
            args = [torch.tensor(v, dtype=dtype, device=device) for v in point]
            hi = loss(*[a + e if i == k else a for i, a in enumerate(args)])
            lo = loss(*[a - e if i == k else a for i, a in enumerate(args)])
            out.append((hi - lo) / (2 * e))
    return torch.stack(out)


def main(argv=None):
    from tds_tpu_torch.envs.laikago import LaikagoEnv

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    env = LaikagoEnv(dtype=torch.float64, device=args.device)
    q0, qd0, link = sliding_start(env)
    loss = make_loss(env, q0, qd0, link, args.steps)
    t0 = time.perf_counter()
    value, grad = gradient(loss, POINT, env.dtype, env.device)
    t1 = time.perf_counter()
    fd = central_differences(loss, POINT, FD_EPS, env.dtype, env.device)
    t2 = time.perf_counter()
    print(f"loss {float(value):.12g} over {args.steps} steps on {env.device}")
    for name, g, f in zip(("kp", "mass scale", "friction"), grad.tolist(), fd.tolist()):
        print(f"d/d {name}: {g:.10e} (central differences {f:.10e}, relative {abs(g - f) / abs(f):.2e})")
    print(f"gradient {t1 - t0:.2f} s, central differences {t2 - t1:.2f} s")


if __name__ == "__main__":
    main()
