"""The port's utilities on the CPU: the Experiment harness (the round trip
of tests/test_experiment.py), the profiling hooks, the numerical-health
guards, the dataset loaders against the JAX package's arrays, and
marching tetrahedra against the native library's C++ loop."""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from tds_tpu_torch.utils import debug, graphs, profiling  # noqa: E402
from tds_tpu_torch.utils.experiment import Experiment, trainer_experiment  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@dataclasses.dataclass
class Inner:
    decay: float = 0.9


@dataclasses.dataclass
class TrainCfg:
    learning_rate: float = 0.01
    batch_size: int = 64
    env: str = "cartpole"
    use_filter: bool = True
    inner: Inner = dataclasses.field(default_factory=Inner)


def test_experiment_round_trip(tmp_path):
    """Flags override the dataclass (nested fields as a.b), settings.json
    holds the config and torch's versions, metrics.jsonl a row a step."""
    exp = Experiment("unit", TrainCfg(), log_root=str(tmp_path))
    cfg = exp.parse_args(["--learning_rate", "0.5", "--batch_size", "128", "--use_filter", "false", "--inner.decay", "0.5"])
    assert (cfg.learning_rate, cfg.batch_size, cfg.env, cfg.use_filter, cfg.inner.decay) == (0.5, 128, "cartpole", False, 0.5)
    exp.start()
    exp.log_metrics(0, {"reward": 1.25})
    exp.log_metrics(1, {"reward": torch.tensor(2.5)})
    exp.finish()
    assert exp.run_dir.startswith(os.path.join(str(tmp_path), "unit"))
    with open(os.path.join(exp.run_dir, "settings.json")) as f:
        settings = json.load(f)
    assert settings["config"]["learning_rate"] == 0.5 and settings["config"]["inner"] == {"decay": 0.5}
    assert settings["torch_version"] == torch.__version__ and "cpu" in settings["devices"]
    assert "jax_version" not in settings
    with open(os.path.join(exp.run_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows[1]["reward"] == 2.5 and rows[1]["step"] == 1 and set(rows[0]) == {"step", "t", "reward"}
    # a trainer's runs go beside its checkpoint unless a log root is named
    beside = trainer_experiment("laikago_ars", {"a": 1}, str(tmp_path / "run" / "policy.pkl"))
    assert os.path.dirname(beside.run_dir) == str(tmp_path / "run")
    rooted = trainer_experiment("laikago_ars", {"a": 1}, "p.pkl", log_root=str(tmp_path / "logs"))
    assert os.path.dirname(rooted.run_dir) == str(tmp_path / "logs" / "laikago_ars")


def test_chrome_tracer_matches_jax_format(tmp_path):
    """ChromeTracer writes the JAX package's JSON: the same keys per event."""
    from tds_tpu.utils.profiling import ChromeTracer as JaxTracer

    files = []
    for cls in (profiling.ChromeTracer, JaxTracer):
        tracer = cls()
        with tracer.zone("outer"):
            with tracer.zone("inner"):
                pass
        path = str(tmp_path / f"{cls.__module__}.json")
        tracer.write(path)
        with open(path) as f:
            files.append(json.load(f))
    assert set(files[0]) == set(files[1]) == {"traceEvents"}
    assert [sorted(e) for e in files[0]["traceEvents"]] == [sorted(e) for e in files[1]["traceEvents"]]
    assert [e["name"] for e in files[0]["traceEvents"]] == ["inner", "outer"]


def test_profile_zone_in_a_trace(tmp_path):
    """profile_zone's name appears in a CPU torch.profiler trace, and
    trace_to writes the trace."""
    with profiling.trace_to(str(tmp_path)) as prof:
        with profiling.profile_zone("tds_zone"):
            torch.ones(8).sum()
    assert any(e.name == "tds_zone" for e in prof.events())
    with open(tmp_path / "trace.json") as f:
        assert "tds_zone" in f.read()


def test_nan_trap():
    """The trap raises at the first operation with a NaN output and is
    silent on finite work; off again, NaNs pass."""
    debug.activate_nan_trap()
    try:
        x = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
        assert float((x * 2 + 1).sum()) == pytest.approx(10.0)
        with pytest.raises(FloatingPointError, match="div"):
            torch.zeros(2) / torch.zeros(2)
    finally:
        debug.activate_nan_trap(False)
    assert bool(torch.isnan(torch.zeros(2) / torch.zeros(2)).all())


def test_finite_guards():
    """check_finite, where_finite and assert_finite_tree; check_finite in a
    graphs.scan body on the CPU raises at the step that goes non-finite."""
    x = torch.tensor([1.0, float("inf"), float("nan")])
    with pytest.raises(FloatingPointError, match="velocity"):
        debug.check_finite(x, "velocity")
    assert debug.where_finite(x).tolist() == [1.0, 0.0, 0.0]
    with pytest.raises(FloatingPointError, match=r"\['b'\]\[1\]"):
        debug.assert_finite_tree({"a": torch.ones(2), "b": (torch.ones(1), x), "c": torch.arange(3)})
    debug.assert_finite_tree({"a": torch.ones(2)})

    def body(carry, consts):
        (v,) = carry
        return (debug.check_finite(v * consts[0], "state"),)

    out = graphs.scan(body, (torch.ones(2),), (torch.tensor(10.0),), 5, key="finite guard")
    assert out[0].tolist() == [1e5, 1e5]
    with pytest.raises(FloatingPointError, match="state"):
        graphs.scan(body, (torch.ones(2),), (torch.tensor(1e30),), 20, key="finite guard")


def test_dataset_loaders_match_jax():
    """The three loaders and pendulum_ik return the JAX package's arrays."""
    from tds_tpu.utils import dataset as j_dataset
    from tds_tpu_torch.utils import dataset

    pairs = [
        (dataset.load_ibm_pendulum(), j_dataset.load_ibm_pendulum()),
        (dataset.load_schmidt_lipson(), j_dataset.load_schmidt_lipson()),
        (dataset.load_schmidt_lipson(trial=1), j_dataset.load_schmidt_lipson(trial=1)),
    ]
    pairs.append((dataset.pendulum_ik(pairs[0][0]), j_dataset.pendulum_ik(pairs[0][1])))
    for got, want in pairs:
        assert got.columns == want.columns and got.dt == want.dt and len(got) > 10
        np.testing.assert_array_equal(got.data, want.data)
    ds = pairs[0][0]
    train, test = ds.split(0.8)
    assert len(train) + len(test) == len(ds) and len(ds.clip(0.5)) == 200
    np.testing.assert_array_equal(ds.select(["x1", "y1"]), ds.data[:, 2:4])


def test_marching_cubes_matches_native():
    """tests/test_native_mesh.py's sphere SDF: the same triangles, in the
    same order, as the native library's C++ loop, within 1e-12; and its
    stop at max_triangles."""
    from tds_tpu.native import mesh as native
    from tds_tpu_torch.native.mesh import marching_cubes

    if native.get_lib() is None:
        pytest.skip("the native mesh library did not build")
    n = 40
    xs = np.linspace(-1.2, 1.2, n)
    zz, yy, xx = np.meshgrid(xs, xs, xs, indexing="ij")
    sdf = np.sqrt(xx**2 + yy**2 + zz**2) - 1.0
    for limit in (500000, 1001):
        want = native.marching_cubes(sdf, origin=(-1.2, -1.2, -1.2), dx=xs[1] - xs[0], max_triangles=limit)
        got = marching_cubes(sdf, origin=(-1.2, -1.2, -1.2), dx=xs[1] - xs[0], max_triangles=limit)
        assert got.shape == want.shape and len(got) > 1000
        np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-12)
    r = np.linalg.norm(got.reshape(-1, 3), axis=-1)
    assert float(np.abs(r - 1.0).max()) < 0.06


def test_every_module_of_the_jax_package_has_a_counterpart():
    """Every module of tds_tpu/ has one of the same path in tds_tpu_torch/,
    but the three the port drops on purpose: algebra/smallmat.py and
    algebra/update.py (JAX workarounds for small matrices and scatter-free
    updates) and contact/pallas_pgs.py (K1's Pallas kernel, whose port is
    contact/pgs.py with csrc/pgs.cu)."""
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]

    def modules(package):
        root = repo / package
        return {str(p.relative_to(root)) for p in root.rglob("*.py") if "data" not in p.parts}

    dropped = {"algebra/smallmat.py", "algebra/update.py", "contact/pallas_pgs.py"}
    assert modules("tds_tpu") - modules("tds_tpu_torch") == dropped
    assert (repo / "tds_tpu_torch" / "contact" / "pgs.py").exists()
