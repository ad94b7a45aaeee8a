"""Real experimental datasets for system identification (counterpart of
tds_tpu/utils/dataset.py), in numpy.

- :class:`Dataset`: a named-column trajectory with train/test clipping;
- :func:`load_ibm_pendulum`: the IBM double pendulum's camera marker CSVs
  at 400 Hz (3 markers, pixel x/y each);
- :func:`pendulum_ik`: closed-form two-link IK from marker positions to
  joint angles, unwrapped;
- :func:`load_schmidt_lipson`: the Schmidt & Lipson (Science 2009) real
  double-pendulum recordings (columns: trial, t, th1, th2, w1, w2,
  w1_smooth, w2_smooth, a1, a2).

Files resolve through ``utils.file_utils.find_file``, which searches the
bundled data.
"""

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from tds_tpu_torch.utils.file_utils import find_file

IBM_PENDULUM_HZ = 400.0  # load_ibm_data.h:17 (time += 1/400 per row)


@dataclasses.dataclass
class Dataset:
    """Named-column trajectory container (dataset.hpp role).

    ``data`` is (T, C); ``columns`` names the C channels; ``dt`` is the
    sample period.
    """

    data: np.ndarray
    columns: Tuple[str, ...]
    dt: float

    def __post_init__(self):
        assert self.data.ndim == 2 and self.data.shape[1] == len(self.columns)

    def __len__(self):
        return self.data.shape[0]

    @property
    def times(self) -> np.ndarray:
        return np.arange(len(self)) * self.dt

    def column(self, name: str) -> np.ndarray:
        return self.data[:, self.columns.index(name)]

    def select(self, names: Sequence[str]) -> np.ndarray:
        idx = [self.columns.index(n) for n in names]
        return self.data[:, idx]

    def clip(self, time_limit: float) -> "Dataset":
        """First ``time_limit`` seconds (ceres_estimation_real.cpp:400
        ``dataset.resize(time_steps)``)."""
        n = int(round(time_limit / self.dt))
        return dataclasses.replace(self, data=self.data[:n])

    def split(self, fraction: float) -> Tuple["Dataset", "Dataset"]:
        n = int(len(self) * fraction)
        return (
            dataclasses.replace(self, data=self.data[:n]),
            dataclasses.replace(self, data=self.data[n:]),
        )


def load_ibm_pendulum(name: str = "ibm-double-pendulum/original/dpc_dataset_csv/0.csv") -> Dataset:
    """IBM double-pendulum camera capture: rows of 6 comma-separated pixel
    coordinates (x0,y0 pivot, x1,y1 mid bob, x2,y2 end bob) at 400 Hz
    (load_ibm_data.h:11-34)."""
    path = find_file(name)
    raw = np.loadtxt(path, delimiter=",", dtype=np.float64)
    return Dataset(
        data=raw,
        columns=("x0", "y0", "x1", "y1", "x2", "y2"),
        dt=1.0 / IBM_PENDULUM_HZ,
    )


def _unwrap(q: np.ndarray) -> np.ndarray:
    """Remove 2*pi jumps between consecutive samples (the
    prevent_wraparound loop, load_ibm_data.h:36-44). np.unwrap implements
    exactly this with a pi threshold; the reference uses 0.9*pi, which on
    400 Hz data selects the same branch."""
    return np.unwrap(q, axis=0)


def pendulum_ik(markers: Dataset) -> Dataset:
    """Closed-form 2-link IK from marker positions to joint angles
    (PendulumIk, load_ibm_data.h:46-76): q0 from the pivot->mid segment
    (minus pi/2 so q=0 hangs straight down in image coordinates), q1 the
    mid->end angle relative to link 1, both unwrapped."""
    x0, y0 = markers.column("x0"), markers.column("y0")
    x1, y1 = markers.column("x1"), markers.column("y1")
    x2, y2 = markers.column("x2"), markers.column("y2")
    q0 = _unwrap(np.arctan2(y1 - y0, x1 - x0))
    q1 = _unwrap(np.arctan2(y2 - y1, x2 - x1) - q0)
    q = np.stack([q0 - np.pi / 2, q1], axis=1)
    # bring the STARTING angles into (-pi, pi] by whole turns (the
    # reference's per-sample `if (q1 > pi) q1 -= 2pi` branch, applied as a
    # constant offset so it cannot re-introduce jumps mid-trajectory)
    q -= 2 * np.pi * np.round(q[0] / (2 * np.pi))
    return Dataset(data=q, columns=("q0", "q1"), dt=markers.dt)


SCHMIDT_LIPSON_COLUMNS = (
    "trial", "t", "th1", "th2", "w1", "w2", "w1s", "w2s", "a1", "a2",
)


def load_schmidt_lipson(
    name: str = "schmidt-lipson-exp-data/real_double_pend_h_1.txt",
    trial: Optional[int] = None,
) -> Dataset:
    """Schmidt & Lipson real double-pendulum recording: whitespace columns
    [trial, time, angle1, angle2, vel1, vel2, vel1_smooth, vel2_smooth,
    accel1, accel2], '%'-comment header. ``trial`` selects one contiguous
    recording (the files concatenate several)."""
    path = find_file(name)
    raw = np.loadtxt(path, comments="%", dtype=np.float64)
    if trial is not None:
        raw = raw[raw[:, 0] == trial]
    t = raw[:, 1]
    dt = float(np.median(np.diff(t))) if len(t) > 1 else 0.01
    return Dataset(data=raw, columns=SCHMIDT_LIPSON_COLUMNS, dt=dt)
