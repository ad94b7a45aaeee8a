"""Mocap motion import and frame blending (counterpart of
tds_tpu/utils/motion_import.py).

DeepMimic-style motion files (LoopMode, FrameDuration, Frames) and the
linear blend of neighbouring frames at any time, on tensors: the blend is
a few tensor operations on a (num_frames, dim) tensor, so it runs batched
over a time tensor and inside a captured step.
"""

import json
import re

import numpy as np
import torch

from tds_tpu_torch.utils.tensors import resolve_device

LOOP_CLAMP = 0
LOOP_WRAP = 1


class Motion:
    """``frames`` (num_frames, dim) on ``device`` (the card unless it names
    another) in ``dtype`` (None: float64, or the tensor's own)."""

    def __init__(self, frames, frame_duration: float, loop_mode: int = LOOP_WRAP, dtype=None, device=None):
        if dtype is None:
            dtype = frames.dtype if isinstance(frames, torch.Tensor) else torch.float64
        self.frames = torch.as_tensor(frames, dtype=dtype, device=resolve_device(device))
        self.frame_duration = float(frame_duration)
        self.loop_mode = loop_mode

    @property
    def total_duration(self) -> float:
        return self.frame_duration * self.frames.shape[0]

    def calculate_frame(self, time):
        """The blend of the frames around ``time`` (a number or a tensor of
        any shape): (..., dim). The frame index is floor(time / fd + fd / 4)
        (the reference's bias); past the clip's end the wrap mode restarts
        it (a floor modulo, so negative times wrap too) and the clamp mode
        holds the final frame."""
        frames, fd = self.frames, self.frame_duration
        time = torch.as_tensor(time, dtype=frames.dtype, device=frames.device)
        num = frames.shape[0]
        n = torch.floor(time / fd + fd / 4.0).to(torch.int64)
        if self.loop_mode == LOOP_CLAMP:
            n = n.clamp(0, num - 1)
            idx_left = n
            idx_right = (idx_left + 1).clamp_max(num - 1)
            alpha = ((time - n.to(time.dtype) * fd) / fd).clamp(0.0, 1.0)
        else:
            idx_left = torch.remainder(n, num)
            idx_right = torch.remainder(idx_left + 1, num)
            alpha = (time - n.to(time.dtype) * fd) / fd
        left, right = frames[idx_left], frames[idx_right]
        return (1.0 - alpha)[..., None] * left + alpha[..., None] * right

    @staticmethod
    def load_from_file(path: str, dtype=torch.float64, device=None) -> "Motion":
        """A DeepMimic-style motion file; the loose JSON of the reference
        data (trailing commas) is accepted."""
        with open(path) as f:
            text = f.read()
        text = re.sub(r",(\s*[\]}])", r"\1", text)
        data = json.loads(text)
        loop = data.get("LoopMode", "Wrap")
        loop_mode = LOOP_WRAP if "wrap" in str(loop).lower() else LOOP_CLAMP
        frames = np.asarray(data["Frames"], dtype=np.float64)
        frame_duration = float(data.get("FrameDuration", 1.0 / 30.0))
        return Motion(frames, frame_duration, loop_mode, dtype=dtype, device=device)
