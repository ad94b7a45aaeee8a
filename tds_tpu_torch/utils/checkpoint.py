"""Loading training checkpoints written by the JAX package
(counterpart of tds_tpu/utils/checkpoint.load_checkpoint).

A checkpoint is a pickle of ``{"state": ..., "metadata": ...}`` whose
state may hold a ``tds_tpu.learn.running_stat.RunningStat``. Unpickling
that with plain ``pickle`` would import ``tds_tpu`` and with it JAX, so
the unpickler here maps that one class to the port's own
:class:`~tds_tpu_torch.learn.running_stat.RunningStat` (same fields) and
refuses every other ``tds_tpu`` global. Arrays come back as numpy arrays.
"""

import importlib
import pickle

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
