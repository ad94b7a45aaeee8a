"""tds_tpu_torch.algebra against tds_tpu.algebra on random batched inputs
(float64 on the CPU, tolerance 1e-12)."""

from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.algebra import inertia as j_inertia  # noqa: E402
from tds_tpu.algebra import linalg as j_linalg  # noqa: E402
from tds_tpu.algebra import quaternion as j_quat  # noqa: E402
from tds_tpu.algebra import rotation as j_rot  # noqa: E402
from tds_tpu.algebra import spatial as j_spatial  # noqa: E402
from tds_tpu.algebra import transform as j_transform  # noqa: E402
from tds_tpu_torch.algebra import inertia as t_inertia  # noqa: E402
from tds_tpu_torch.algebra import quaternion as t_quat  # noqa: E402
from tds_tpu_torch.algebra import rotation as t_rot  # noqa: E402
from tds_tpu_torch.algebra import spatial as t_spatial  # noqa: E402
from tds_tpu_torch.algebra import transform as t_transform  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def cpu_settings():
    """Torch on one thread: its many small operations gain nothing from
    more, and the test workers' threads would contend for the cores. The
    JAX package's reference compiled without XLA's optimisation passes:
    its compiles are most of these tests' time, and its results agree to
    rounding."""
    threads, optimized = torch.get_num_threads(), jax.config.read("jax_disable_most_optimizations")
    torch.set_num_threads(1)
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", optimized)
    jax.clear_caches()  # jit's caches ignore the flag: drop the unoptimised executables
    torch.set_num_threads(threads)

TOL = 1e-12
B = 7

JAX = SimpleNamespace(
    spatial=j_spatial, transform=j_transform, inertia=j_inertia, quaternion=j_quat,
    rotation=j_rot, inv3=j_linalg.inv3, cross=jnp.cross, t=jnp.asarray,
)
TORCH = SimpleNamespace(
    spatial=t_spatial, transform=t_transform, inertia=t_inertia, quaternion=t_quat,
    rotation=t_rot, inv3=t_inertia.inv3, cross=t_spatial.cross, t=torch.from_numpy,
)


def _spd(rng):
    m = rng.normal(size=(B, 3, 3))
    return m @ np.swapaxes(m, -1, -2) + 3.0 * np.eye(3)


def _inputs(rng):
    quat = rng.normal(size=(2, B, 4))
    axis = rng.normal(size=(B, 3))
    return dict(
        a6=rng.normal(size=(B, 6)),
        b6=rng.normal(size=(B, 6)),
        v3=rng.normal(size=(B, 3)),
        pos=rng.normal(size=(2, B, 3)),
        rot=np.asarray(j_quat.to_matrix(jnp.asarray(quat / np.linalg.norm(quat, axis=-1, keepdims=True)))),
        mass=rng.uniform(0.5, 2.0, size=(B,)),
        inertia=_spd(rng),
        abi=(_spd(rng), rng.normal(size=(B, 3, 3)), _spd(rng)),
        quat=rng.normal(size=(B, 4)),
        unit_axis=axis / np.linalg.norm(axis, axis=-1, keepdims=True),
        angle=rng.normal(size=(B,)),
        rpy=rng.normal(size=(3, B)),
    )


def _x(L, x, k=0):
    return L.transform.Transform(pos=L.t(x["pos"][k]), rot=L.t(x["rot"][k]))


def _abi(L, x):
    return L.inertia.ArticulatedBodyInertia(*(L.t(m) for m in x["abi"]))


def _rbi(L, x):
    return L.inertia.RigidBodyInertia(mass=L.t(x["mass"]), h=L.t(x["v3"]), inertia=L.t(x["inertia"]))


# name -> function of (framework namespace, numpy inputs), run on both
CASES = {
    "spatial.cross_mm": lambda L, x: L.spatial.cross_mm(L.t(x["a6"]), L.t(x["b6"])),
    "spatial.cross_mf": lambda L, x: L.spatial.cross_mf(L.t(x["a6"]), L.t(x["b6"])),
    "spatial.dot": lambda L, x: L.spatial.dot(L.t(x["a6"]), L.t(x["b6"])),
    "spatial.cross_matrix": lambda L, x: L.spatial.cross_matrix(L.t(x["v3"])),
    "spatial.mv_broadcast": lambda L, x: L.spatial.mv(L.t(x["v3"][0]), L.t(x["v3"])),
    "spatial.cross_broadcast": lambda L, x: L.cross(L.t(x["v3"][0]), L.t(x["pos"][0])),
    "transform.compose": lambda L, x: tuple(_x(L, x, 0).compose(_x(L, x, 1))),
    "transform.inverse": lambda L, x: tuple(_x(L, x).inverse()),
    "transform.apply_point": lambda L, x: _x(L, x).apply_point(L.t(x["v3"])),
    "transform.apply_inverse_point": lambda L, x: _x(L, x).apply_inverse_point(L.t(x["v3"])),
    "transform.motion_to_child": lambda L, x: _x(L, x).motion_to_child(L.t(x["a6"])),
    "transform.motion_to_parent": lambda L, x: _x(L, x).motion_to_parent(L.t(x["a6"])),
    "transform.motion_unbatched_vector": lambda L, x: _x(L, x).motion_to_parent(L.t(x["a6"][0])),
    "transform.force_to_child": lambda L, x: _x(L, x).force_to_child(L.t(x["b6"])),
    "transform.force_to_parent": lambda L, x: _x(L, x).force_to_parent(L.t(x["b6"])),
    "transform.abi_to_parent": lambda L, x: tuple(_x(L, x).abi_to_parent(_abi(L, x))),
    "inertia.inv3": lambda L, x: L.inv3(L.t(x["inertia"])),
    "inertia.rbi_mul_motion": lambda L, x: _rbi(L, x).mul_motion(L.t(x["a6"])),
    "inertia.abi_from_rbi": lambda L, x: tuple(L.inertia.ArticulatedBodyInertia.from_rbi(_rbi(L, x))),
    "inertia.abi_mul_motion": lambda L, x: _abi(L, x).mul_motion(L.t(x["a6"])),
    "inertia.abi_inverse": lambda L, x: tuple(_abi(L, x).inverse()),
    "inertia.abi_matrix": lambda L, x: _abi(L, x).matrix(),
    "inertia.abi_add_sub": lambda L, x: tuple(_abi(L, x) + _abi(L, x)) + tuple(_abi(L, x) - _abi(L, x).from_rbi(_rbi(L, x))),
    "inertia.outer_ff": lambda L, x: tuple(L.inertia.ArticulatedBodyInertia.outer_ff(L.t(x["a6"]), L.t(x["b6"]))),
    "quaternion.to_matrix": lambda L, x: L.quaternion.to_matrix(L.t(x["quat"])),
    "quaternion.from_axis_angle": lambda L, x: L.quaternion.from_axis_angle(L.t(x["unit_axis"]), L.t(x["angle"])),
    "rotation.rotation_x": lambda L, x: L.rotation.rotation_x(L.t(x["angle"])),
    "rotation.rotation_y": lambda L, x: L.rotation.rotation_y(L.t(x["angle"])),
    "rotation.rotation_z": lambda L, x: L.rotation.rotation_z(L.t(x["angle"])),
    "rotation.from_rpy": lambda L, x: L.rotation.from_rpy(*(L.t(a) for a in x["rpy"])),
}


def _close(got, expected):
    if isinstance(got, tuple):
        assert len(got) == len(expected)
        for g, e in zip(got, expected):
            _close(g, e)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(expected), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_algebra_matches_jax(name):
    x = _inputs(np.random.default_rng(sorted(CASES).index(name)))
    _close(CASES[name](TORCH, x), CASES[name](JAX, x))
