"""The port's laikago model against the JAX package's: every array leaf at
1e-15 and every static field exactly (float64 on the CPU)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from tds_tpu.urdf.cache import construct as j_construct  # noqa: E402
from tds_tpu_torch.model.multibody import MultiBodyBuilder  # noqa: E402
from tds_tpu_torch.urdf.cache import construct as t_construct  # noqa: E402
from tds_tpu_torch.utils.file_utils import find_file  # noqa: E402

URDF = "laikago/laikago_toes_zup_xyz_xyzrot.urdf"
LEAVES = (
    "x_t_pos", "x_t_rot", "joint_axis", "mass", "com", "inertia", "stiffness",
    "damping", "base_mass", "base_com", "base_inertia", "base_pos", "base_rot",
    "joint_damping",
)
STATIC = (
    "joint_types", "parents", "q_offsets", "qd_offsets", "is_floating", "dof_q",
    "dof_qd", "dof_actuated", "link_names", "joint_names", "name",
)


@pytest.fixture(scope="module")
def models():
    j_model, j_geoms = j_construct(URDF, dtype=jnp.float64)
    t_model, t_geoms = t_construct(URDF)
    return j_model, j_geoms, t_model, t_geoms


@pytest.mark.parametrize("leaf", LEAVES)
def test_array_leaf_matches_jax(models, leaf):
    j_model, _, t_model, _ = models
    got = getattr(t_model, leaf)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(getattr(j_model, leaf)), rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("field", STATIC)
def test_static_field_matches_jax(models, field):
    j_model, _, t_model, _ = models
    assert getattr(t_model, field) == getattr(j_model, field)


def test_laikago_shape_of_the_slice(models):
    _, _, t_model, t_geoms = models
    assert (t_model.dof_q, t_model.dof_qd, t_model.num_links) == (18, 18, 22)
    assert len(t_geoms) == 4


def test_geoms_match_jax_with_friction(models):
    _, j_geoms, _, t_geoms = models
    assert len(t_geoms) == len(j_geoms)
    for t, j in zip(t_geoms, j_geoms):
        assert type(t.shape).__name__ == type(j.shape).__name__
        assert dataclasses.asdict(t.shape) == dataclasses.asdict(j.shape)
        for field in ("link_index", "pos", "rpy", "friction", "restitution"):
            assert getattr(t, field) == getattr(j, field), field


def test_subspaces_match_jax(models):
    j_model, _, t_model, _ = models
    for i in range(t_model.num_links):
        np.testing.assert_array_equal(t_model.subspaces[i].numpy(), np.asarray(j_model.motion_subspace(i)))


def test_model_to_moves_every_leaf(models):
    _, _, t_model, _ = models
    moved = t_model.to(dtype=torch.float32)
    for leaf in LEAVES:
        assert getattr(moved, leaf).dtype == torch.float32
    assert moved.joint_types == t_model.joint_types
    assert moved.subspaces.dtype == torch.float32


def test_data_path_override(tmp_path, monkeypatch):
    (tmp_path / "laikago").mkdir()
    target = tmp_path / URDF
    target.write_text("<robot name='x'/>")
    monkeypatch.setenv("TDS_TPU_DATA_PATH", str(tmp_path))
    assert find_file(URDF) == str(target)


def test_builder_rejects_out_of_order_links():
    with pytest.raises(ValueError):
        MultiBodyBuilder().add_link(0, parent=3)
