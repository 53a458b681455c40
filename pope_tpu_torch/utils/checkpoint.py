"""Training checkpoints (port of pope_tpu/utils/checkpoint.py's save /
load / latest; orbax checkpoints are not read).

A checkpoint is a directory holding one `torch.save` file of the model's
state_dict, the optimizer's and the scheduler's state and the step count;
it is written to a temporary file first and moved into place with
os.replace, so that a reader never sees half a file.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional

import torch

FILE = "checkpoint.pt"


def save_checkpoint(path: str, state) -> str:
    """Write a MatcherTrainState (train/trainer.py) under directory `path`."""
    os.makedirs(path, exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
    }
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
        os.replace(tmp, os.path.join(path, FILE))
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def load_checkpoint(path: str, like):
    """Restore the checkpoint under `path` into `like` (a MatcherTrainState
    of the same architecture, on its device) in place; returns it."""
    dev = next(like.model.parameters()).device
    payload = torch.load(os.path.join(path, FILE), map_location=dev, weights_only=True)
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
