"""Experiment harness: CLI flags, structured JSON logs and run directories
(counterpart of tds_tpu/utils/experiment.py).

A dataclass config round-trips through argparse and JSON; a run directory
``<log_root>/<name>/<stamp>/`` holds ``settings.json`` (the config, the git
commit, torch's and CUDA's versions and the devices) and ``metrics.jsonl``,
one JSON row a logged step.
"""

import argparse
import dataclasses
import datetime
import json
import os
import subprocess
import time
from typing import Any, Dict, Optional


def _flatten(prefix, obj, out):
    """Nested dataclass or dict fields as ``a.b`` keys."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        obj = dataclasses.asdict(obj)
    if isinstance(obj, dict):
        for k, v in obj.items():
            if isinstance(v, dict):
                _flatten(f"{prefix}{k}.", v, out)
            else:
                out[f"{prefix}{k}"] = v
    return out


def _bool(s: str) -> bool:
    return s.lower() in ("1", "true", "yes")


class Experiment:
    def __init__(self, name: str, config: Any = None, log_root: str = "./logs"):
        self.name = name
        self.config = config
        self.log_root = log_root
        self._stamp = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
        self._metrics_file = None
        self._t0 = time.time()

    @property
    def run_dir(self):
        # from the current name: a caller may rename the run before start()
        return os.path.join(self.log_root, self.name, self._stamp)

    # -- CLI ---------------------------------------------------------------
    def parse_args(self, argv=None):
        """Every (flattened) config field as a ``--flag``; returns the
        updated config."""
        if self.config is None:
            return None
        parser = argparse.ArgumentParser(prog=self.name)
        for key, val in _flatten("", self.config, {}).items():
            if isinstance(val, bool):
                parser.add_argument(f"--{key}", type=_bool, default=val)
            elif isinstance(val, (int, float, str)):
                parser.add_argument(f"--{key}", type=type(val), default=val)
        args = vars(parser.parse_args(argv))

        def rebuild(cfg, prefix=""):
            if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
                updates = {}
                for f in dataclasses.fields(cfg):
                    key = f"{prefix}{f.name}"
                    val = getattr(cfg, f.name)
                    if dataclasses.is_dataclass(val):
                        updates[f.name] = rebuild(val, key + ".")
                    elif key in args:
                        updates[f.name] = args[key]
                return dataclasses.replace(cfg, **updates)
            return cfg

        self.config = rebuild(self.config)
        return self.config

    # -- run lifecycle -----------------------------------------------------
    def start(self):
        os.makedirs(self.run_dir, exist_ok=True)
        meta = {
            "name": self.name,
            "started": datetime.datetime.now().isoformat(),
            "git_commit": _git_commit(),
        }
        meta.update(_versions())
        if self.config is not None:
            meta["config"] = (
                dataclasses.asdict(self.config) if dataclasses.is_dataclass(self.config) else dict(self.config)
            )
        with open(os.path.join(self.run_dir, "settings.json"), "w") as f:
            json.dump(meta, f, indent=2, default=str)
        self._metrics_file = open(os.path.join(self.run_dir, "metrics.jsonl"), "a")
        return self

    def log_metrics(self, step: int, metrics: Dict[str, Any]):
        row = {"step": step, "t": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        self._metrics_file.write(json.dumps(row) + "\n")
        self._metrics_file.flush()

    def finish(self):
        if self._metrics_file:
            self._metrics_file.close()
            self._metrics_file = None


def trainer_experiment(name: str, config, checkpoint: str, log_root: Optional[str] = None) -> Experiment:
    """A trainer's Experiment: runs under ``<log_root>/<name>/``, or, with no
    ``log_root``, beside the checkpoint (``./logs/<env>_ars/policy.pkl``'s
    runs in ``./logs/<env>_ars/<stamp>/``, as the JAX trainers lay them
    out)."""
    if log_root is None:
        folder = os.path.dirname(os.path.abspath(checkpoint))
        return Experiment(os.path.basename(folder), config, log_root=os.path.dirname(folder))
    return Experiment(name, config, log_root=log_root)


def _versions() -> Dict[str, Any]:
    """torch's version, the CUDA version it was built for, and the devices."""
    import torch

    devices = ["cpu"]
    if torch.cuda.is_available():
        devices += [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    return {"torch_version": torch.__version__, "cuda_version": torch.version.cuda, "devices": devices}


def _git_commit() -> Optional[str]:
    """HEAD of the checkout this file lies in, or None outside a git tree."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, timeout=5, cwd=os.path.dirname(os.path.abspath(__file__))
        )
        return out.stdout.decode().strip() or None
    except Exception:
        return None
