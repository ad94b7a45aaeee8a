"""The probe kernels K3 and K4 (tds_tpu_torch.tools.kernel_probe): their
plain versions at the probe shapes of tools/mosaic_probe.py against numpy
and against that file's own Pallas kernels in interpret mode, the device
dispatch, and the nvcc build's refusal without a compiler. The card tests
(marked ``cuda``) hold the kernels to their plain versions exactly and skip
without a card. The file imports JAX only inside the test that compares
with the JAX package's kernels, which skips where JAX is missing, so it
runs on a card machine without JAX."""

import importlib.util
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.tools import kernel_probe  # noqa: E402
from tds_tpu_torch.utils import cuda_build  # noqa: E402


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {name: rng.normal(size=shape).astype(np.float32) for name, shape in kernel_probe.PROBE_SHAPES.items()}


def test_plain_versions_at_the_probe_shapes():
    x = _inputs()
    got = kernel_probe.reshape_sum(torch.from_numpy(x["reshape_sum"]))
    assert got.shape == (256, 4)
    np.testing.assert_array_equal(got.numpy(), x["reshape_sum"][:, 0::2] + x["reshape_sum"][:, 1::2])
    got = kernel_probe.transpose_minor(torch.from_numpy(x["transpose_minor"]))
    assert got.shape == (8, 8, 128) and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.swapaxes(x["transpose_minor"], -1, -2))


MOSAIC_PROBE = os.path.join(os.path.dirname(__file__), os.pardir, "tools", "mosaic_probe.py")
JAX_PROBE_OF = {"reshape_sum": "minor_dim_reshape", "transpose_minor": "minor_dim_transpose"}


def _jax_probe_kernel(name):
    """The Pallas kernel of tools/mosaic_probe.py's probe ``name``, its body
    and output shape read from the probe's source, in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    spec = importlib.util.spec_from_file_location("mosaic_probe", MOSAIC_PROBE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    source = module.PROBES[name]
    body = re.search(r"o_ref\[\.\.\.\] = x_ref\[\.\.\.\](.+)", source).group(1).strip()
    out_shape = tuple(int(d) for d in re.search(r"ShapeDtypeStruct\(\(([\d, ]+)\)", source).group(1).split(","))

    def kernel(x_ref, o_ref):
        o_ref[...] = eval("x" + body, {}, {"x": x_ref[...]})

    return pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32), interpret=True)


@pytest.mark.parametrize("name", sorted(JAX_PROBE_OF))
def test_plain_versions_match_the_jax_probe_kernels(name):
    """The port's probe on the CPU against the JAX package's probe kernel
    on the same seeded input: exactly equal."""
    pytest.importorskip("jax")
    x = _inputs()[name]
    expected = np.asarray(_jax_probe_kernel(JAX_PROBE_OF[name])(x))
    got = getattr(kernel_probe, name)(torch.from_numpy(x))
    assert got.shape == expected.shape
    np.testing.assert_array_equal(got.numpy(), expected)


def test_run_probes_on_the_cpu_compares_plain_with_plain():
    before = dict(kernel_probe.launches)
    assert kernel_probe.run_probes(device="cpu") == {"reshape_sum": 0.0, "transpose_minor": 0.0}
    assert kernel_probe.launches == before


@pytest.mark.parametrize("name", ["reshape_sum", "transpose_minor"])
def test_wrappers_refuse_other_devices_and_shapes(name):
    fn = getattr(kernel_probe, name)
    with pytest.raises(ValueError, match="no .* implementation"):
        fn(torch.zeros(kernel_probe.PROBE_SHAPES[name], device="meta"))
    with pytest.raises(ValueError):
        fn(torch.zeros(3))


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("TDS_TPU_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("probes.cu")


def test_probe_command_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tested by test_kernels_match_their_plain_versions_on_the_card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernel_probe.main()


@pytest.mark.cuda
def test_kernels_match_their_plain_versions_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the probe kernels have no CPU mode")
    x = {name: torch.from_numpy(a).cuda() for name, a in _inputs(1).items()}
    expected = {
        "reshape_sum": kernel_probe.reshape_sum_reference(x["reshape_sum"]).cpu(),
        "transpose_minor": kernel_probe.transpose_minor_reference(x["transpose_minor"]).cpu(),
    }

    def refuse(*args):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(kernel_probe, "reshape_sum_reference", refuse)
    monkeypatch.setattr(kernel_probe, "transpose_minor_reference", refuse)
    before = dict(kernel_probe.launches)
    for name in expected:
        got = getattr(kernel_probe, name)(x[name])
        torch.cuda.synchronize()
        torch.testing.assert_close(got.cpu(), expected[name], rtol=0, atol=0)
        assert kernel_probe.launches[name] == before[name] + 1
    with pytest.raises(TypeError):
        kernel_probe.reshape_sum(x["reshape_sum"].double())
