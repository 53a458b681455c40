"""Training checkpoints and reference weights (port of
pope_tpu/utils/checkpoint.py; orbax checkpoints are not read).

A checkpoint is a directory holding one `torch.save` file: for matcher
training the model's state_dict, the optimizer's and the scheduler's state
and the step count, for SSL training SSLState.state_dict(). It is written
to a temporary file first and moved into place with os.replace, so that a
reader never sees half a file.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import numpy as np
import torch

FILE = "checkpoint.pt"


def save_payload(path: str, payload: dict) -> str:
    """torch.save `payload` as the checkpoint under directory `path`,
    atomically."""
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, os.path.join(path, FILE))
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def load_payload(path: str, device) -> dict:
    """The payload of the checkpoint under `path`, its tensors on `device`."""
    return torch.load(os.path.join(path, FILE), map_location=device, weights_only=True)


def save_checkpoint(path: str, state) -> str:
    """Write a MatcherTrainState (train/trainer.py) under directory `path`."""
    return save_payload(path, {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
    })


def load_checkpoint(path: str, like):
    """Restore the checkpoint under `path` into `like` (a MatcherTrainState
    of the same architecture, on its device) in place; returns it."""
    payload = load_payload(path, next(like.model.parameters()).device)
    like.model.load_state_dict(payload["model"])
    like.optimizer.load_state_dict(payload["optimizer"])
    like.scheduler.load_state_dict(payload["scheduler"])
    like.step = int(payload["step"])
    return like


def latest_checkpoint(ckpt_dir: str, prefix: str = "step_") -> Optional[str]:
    """The `<prefix><n>` entry of ckpt_dir with the largest n, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith(prefix):
            try:
                steps.append((int(name[len(prefix):]), name))
            except ValueError:
                continue
    if not steps:
        return None
    return os.path.join(ckpt_dir, max(steps)[1])


def load_torch_state_dict(path: str, checkpoint_key: Optional[str] = None) -> dict:
    """A reference .pth as {name: np.ndarray}, unwrapping the common
    {checkpoint_key: ...} / {'state_dict': ...} / {'model': ...} layouts.
    The file is unpickled in full (weights_only=False, as pope_tpu reads
    it): load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in (checkpoint_key, "state_dict", "model"):
        if key and isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in obj.items()}
