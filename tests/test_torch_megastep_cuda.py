"""The fused step kernel (csrc/megastep.cu) on a CUDA device against the
port's plain version, one step from states where every env touches the
ground: float64 within 1e-9 abs + rel (the bound chip_smoke.py holds the
card to), float32 within 1e-4 abs + rel on qd and 1e-6 on q (the size
of float32 rounding in a contact step, tests/test_torch_megastep.py), also
at batches that fill no whole block; and its launch shape on the card. Every
test here needs the card and skips without one. The file imports neither
JAX nor the JAX package, so on a machine with a card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_megastep_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.envs.laikago import LaikagoEnv  # noqa: E402
from tds_tpu_torch.envs import fused_step  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float64: ((1e-9, 1e-9), (1e-9, 1e-9)), torch.float32: ((1e-6, 1e-6), (1e-4, 1e-4))}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused step kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def standing():
    """float64 states 100 steps after a standing start at batch 130 (every
    env on the ground), and seeded actions in +-0.4. Module-scoped, so set
    up before ``cuda_device`` skips: it skips first itself."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused step kernel has no CPU mode")
    env = LaikagoEnv(dtype=torch.float64, device="cpu")
    params = fused_step.pack_step_params(env)
    rng = np.random.default_rng(7)
    q, qd = env.initial_state(noise=torch.from_numpy(rng.uniform(-0.05, 0.05, (130, env.action_dim))))
    zero = torch.zeros(130, env.action_dim, dtype=torch.float64)
    for _ in range(100):
        q, qd = fused_step.mega_step_reference(params, q, qd, zero)
    assert bool(((fused_step.sphere_distances(params, q) < 0).sum(-1) > 0).all())
    return q, qd, torch.from_numpy(rng.uniform(-0.4, 0.4, (130, env.action_dim)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_tensor_never_reaches_the_plain_path(cuda_device, standing, monkeypatch, dtype):
    cpu_params = fused_step.pack_step_params(LaikagoEnv(dtype=dtype, device="cpu"))
    params = fused_step.pack_step_params(LaikagoEnv(dtype=dtype, device=cuda_device))
    state = [t.to(dtype) for t in standing]
    expected = fused_step.mega_step_reference(cpu_params, *state)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain fused step ran on a CUDA tensor")

    monkeypatch.setattr(fused_step, "mega_step_reference", refuse)
    before = fused_step.launches
    got = fused_step.mega_step(params, *(t.to(cuda_device) for t in state))
    torch.cuda.synchronize()
    assert fused_step.launches == before + 1
    for g, e, (rtol, atol) in zip(got, expected, TOL[dtype]):
        torch.testing.assert_close(g.cpu(), e, rtol=rtol, atol=atol)


@pytest.mark.parametrize("batch", [1, 37, 130])
@pytest.mark.parametrize("dtype", fused_step.DTYPES)
def test_ragged_batches_match_the_plain_step(cuda_device, standing, dtype, batch):
    """Batches that fill no whole block: the groups past the end of the
    batch take part in every shuffle of the sweep and store nothing."""
    cpu_params = fused_step.pack_step_params(LaikagoEnv(dtype=dtype, device="cpu"))
    params = fused_step.pack_step_params(LaikagoEnv(dtype=dtype, device=cuda_device))
    state = [t[:batch].to(dtype).contiguous() for t in standing]
    expected = fused_step.mega_step_reference(cpu_params, *state)
    got = fused_step.mega_step(params, *(t.to(cuda_device) for t in state))
    torch.cuda.synchronize()
    for g, e, (rtol, atol) in zip(got, expected, TOL[dtype]):
        assert g.shape == e.shape
        torch.testing.assert_close(g.cpu(), e, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", fused_step.DTYPES)
def test_every_instance_has_a_block_resident_per_sm(cuda_device, dtype):
    params = fused_step.pack_step_params(LaikagoEnv(dtype=dtype, device=cuda_device))
    shape = fused_step.launch_shape(params, 16384)
    lanes = fused_step.LANES_PER_ENV
    assert shape["blocks_per_sm"] >= 1 and shape["lanes_per_env"] == lanes
    assert shape["envs_per_block"] * lanes == shape["threads_per_block"]


def test_cuda_kernel_refuses_shapes_without_an_instance(cuda_device, standing):
    params = fused_step.pack_step_params(LaikagoEnv(dtype=torch.float64, device=cuda_device))
    q, qd, action = (t.to(cuda_device) for t in standing)
    three_spheres = params._replace(
        **{f: getattr(params, f)[:3] for f in ("sphere_links", "sphere_offsets", "sphere_radii", "friction", "restitution")}
    )
    with pytest.raises(ValueError, match="built for"):
        fused_step.mega_step(three_spheres, q, qd, action)
    with pytest.raises(ValueError, match="built for"):
        fused_step.mega_step(params._replace(num_friction_dir=1), q, qd, action)
    with pytest.raises(TypeError):
        fused_step.mega_step(params, q.float(), qd, action)
    with pytest.raises(ValueError):
        fused_step.mega_step(params, q[:, :12].contiguous(), qd, action)


def test_cuda_kernel_refuses_gradients_it_would_drop(cuda_device, standing):
    """K2 has no backward: under grad, an operand that requires grad is
    refused; under torch.no_grad() the same call returns what it returns
    without one."""
    params = fused_step.pack_step_params(LaikagoEnv(dtype=torch.float64, device=cuda_device))
    q, qd, action = (t.to(cuda_device) for t in standing)
    expected = fused_step.mega_step(params, q, qd, action)
    before = fused_step.launches
    with pytest.raises(RuntimeError, match="no backward"):
        fused_step.mega_step(params, q, qd, action.clone().requires_grad_())
    with pytest.raises(RuntimeError, match="no backward"):
        fused_step.mega_step(params._replace(kp=params.kp.clone().requires_grad_()), q, qd, action)
    assert fused_step.launches == before
    with torch.no_grad():
        got = fused_step.mega_step(params, q.clone().requires_grad_(), qd, action.clone().requires_grad_())
    torch.cuda.synchronize()
    for g, e in zip(got, expected):
        assert torch.equal(g, e) and not g.requires_grad
