"""Training checkpoints in the JAX package's format (counterpart of
tds_tpu/utils/checkpoint.{save_checkpoint, load_checkpoint}).

A checkpoint is a pickle of ``{"state": ..., "metadata": ...}``. The JAX
package's state may hold a ``tds_tpu.learn.running_stat.RunningStat``.
Unpickling that with plain ``pickle`` would import ``tds_tpu`` and with it
JAX, so the unpickler here maps that one class to the port's own
:class:`~tds_tpu_torch.learn.running_stat.RunningStat` (same fields) and
refuses every other ``tds_tpu`` global. Arrays come back as numpy arrays.

:func:`save_checkpoint` writes tensors as numpy arrays and every tuple,
the port's ``RunningStat`` among them, as a plain tuple, so the file
unpickles without ``tds_tpu_torch`` or ``tds_tpu``: the JAX package's
trainer reads its ``obs_stat`` as ``RunningStat(*obs_stat)``.

:func:`save_policy_weights` and :func:`load_policy_weights` write and read
the JAX package's flat policy dump: the weights as raw float64 in a
``.bin`` file, with ``<path>.json`` beside it holding their count (and the
reward when given), so that each package reads the other's.
"""

import importlib
import json
import os
import pickle
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from tds_tpu_torch.learn.running_stat import RunningStat

_MAPPED = {("tds_tpu.learn.running_stat", "RunningStat"): RunningStat}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _MAPPED:
            return _MAPPED[(module, name)]
        if module == "tds_tpu" or module.startswith("tds_tpu."):
            raise pickle.UnpicklingError(f"refusing to load {module}.{name} from a checkpoint")
        if module.startswith("numpy._core"):
            # pickles from numpy >= 2 name numpy._core; numpy 1.x has numpy.core
            try:
                importlib.import_module(module)
            except ImportError:
                module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def load_checkpoint(path: str):
    """Returns (state, metadata)."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    return payload["state"], payload["metadata"]


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_to_host(v) for v in x)
    if isinstance(x, list):
        return [_to_host(v) for v in x]
    return x


def save_checkpoint(path: str, state: Any, metadata: Optional[dict] = None):
    """Atomic pickle of ``state`` (tensors -> numpy, tuples -> plain
    tuples) and ``metadata``: written to a temporary file beside ``path``,
    then renamed over it."""
    payload = {"state": _to_host(state), "metadata": metadata or {}}
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_policy_weights(path: str, params, reward: Optional[float] = None):
    """The flat weights ``params`` (a tensor or an array) as raw float64 at
    ``path``, and ``{"size": n[, "reward": r]}`` at ``path + ".json"``."""
    arr = (params.detach().cpu().numpy() if isinstance(params, torch.Tensor) else np.asarray(params)).astype(np.float64)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr.tofile(path)
    meta = {"size": int(arr.size)}
    if reward is not None:
        meta["reward"] = float(reward)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_policy_weights(path: str) -> np.ndarray:
    """The flat float64 weights at ``path``."""
    return np.fromfile(path, dtype=np.float64)
