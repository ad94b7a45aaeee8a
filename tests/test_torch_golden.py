"""The port against the C++ reference's goldens, float64 on the CPU, at the
tolerances of tests/test_golden_reference.py (which holds the JAX package
to the same files):

- ``tests/golden/pendulum5_swing.json``: ``forward_dynamics`` and
  ``integrate_euler`` of pendulum5.urdf for 1000 steps from the golden's
  start, q and qd at every snapshot within 1e-10 to step 200, 1e-8 to 500
  and 1e-6 after (a chaotic system);
- ``tests/golden/swimmer_random_sweep.json``: ABA at every case within
  1e-9 (rtol and atol) and CRBA at every case that has a mass matrix within
  rtol 1e-10, atol 1e-12, all cases as one batch.

No JAX: the goldens are the reference's own numbers.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tds_tpu_torch.dynamics import forward_dynamics, integrate_euler  # noqa: E402
from tds_tpu_torch.dynamics.mass_matrix import mass_matrix  # noqa: E402
from tds_tpu_torch.urdf.cache import construct  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return json.load(f)


def test_pendulum5_trajectory_matches_reference():
    golden = _golden("pendulum5_swing.json")
    model, _ = construct("pendulum5.urdf")
    gravity = torch.tensor(golden["gravity"], dtype=torch.float64)
    snaps = golden["snapshots"]
    q = torch.tensor(snaps["0"]["q"], dtype=torch.float64)[None]
    qd = torch.tensor(snaps["0"]["qd"], dtype=torch.float64)[None]
    tau = torch.zeros(1, model.dof_actuated, dtype=torch.float64)
    checked = 0
    for t in range(1, 1001):
        qdd = forward_dynamics(model, q, qd, tau, gravity)
        q, qd = integrate_euler(model, q, qd, qdd, golden["dt"])
        if str(t) in snaps:
            tol = 1e-10 if t <= 200 else (1e-8 if t <= 500 else 1e-6)
            np.testing.assert_allclose(q[0].numpy(), snaps[str(t)]["q"], rtol=tol, atol=tol, err_msg=f"q at step {t}")
            np.testing.assert_allclose(qd[0].numpy(), snaps[str(t)]["qd"], rtol=tol, atol=tol, err_msg=f"qd at step {t}")
            checked += 1
    assert checked >= 5


def test_swimmer_random_sweep_matches_reference():
    golden = _golden("swimmer_random_sweep.json")
    model, _ = construct("swimmer/swimmer05/swimmer05.urdf")
    assert model.dof_q == golden["dof"] and model.dof_qd == golden["dof_qd"]
    gravity = torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64)
    cases = golden["cases"]
    q, qd, tau = (torch.tensor([c[k] for c in cases], dtype=torch.float64) for k in ("q", "qd", "tau"))
    qdd = forward_dynamics(model, q, qd, tau, gravity)
    np.testing.assert_allclose(qdd.numpy(), [c["qdd"] for c in cases], rtol=1e-9, atol=1e-9, err_msg="ABA")
    with_m = [c for c in cases if "mass_matrix" in c]
    assert with_m
    m = mass_matrix(model, torch.tensor([c["q"] for c in with_m], dtype=torch.float64))
    np.testing.assert_allclose(m.numpy(), [c["mass_matrix"] for c in with_m], rtol=1e-10, atol=1e-12, err_msg="CRBA")
