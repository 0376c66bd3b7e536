"""Checkpoints of the port's models and training state.

``save_checkpoint`` / ``load_checkpoint`` keep a model's ``state_dict``
(the best-model checkpoint; ``SGRACEConfig.preload`` reads it);
``save_train_state`` / ``load_train_state`` add the optimizer's state and
the step count, so a run resumes where it stopped. Files are
``torch.save`` dictionaries of tensors, read back with
``weights_only=True``; the JAX package's flax msgpack files are not read.
``save_train_state_sharded`` / ``load_train_state_sharded`` keep the same
state with ``torch.distributed.checkpoint`` under ``directory/step_{step}``,
as the JAX package's orbax pair does.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch


def _cpu(sd: Mapping) -> dict:
    return {k: v.detach().cpu() for k, v in sd.items()}


def save_checkpoint(path: str, params: Mapping) -> None:
    """Save a ``state_dict`` (tensors are copied to the CPU)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(_cpu(params), path)


def load_checkpoint(path: str, target: Optional[Mapping] = None) -> dict:
    """Load a ``state_dict`` saved by ``save_checkpoint``. With ``target``
    (a ``state_dict``), the keys and shapes must match it and the tensors
    come back on its devices and dtypes."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if target is None:
        return sd
    if set(sd) != set(target):
        raise KeyError(f"checkpoint keys {sorted(sd)} != {sorted(target)}")
    out = {}
    for k, ref in target.items():
        if sd[k].shape != ref.shape:
            raise ValueError(f"{k}: checkpoint shape {tuple(sd[k].shape)} != {tuple(ref.shape)}")
        out[k] = sd[k].to(device=ref.device, dtype=ref.dtype)
    return out


def save_train_state(path: str, state) -> None:
    """Save a ``train.loop.TrainState``: model, optimizer and step."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(
        {
            "model": _cpu(state.model.state_dict()),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
        },
        path,
    )


def load_train_state(path: str, state):
    """Restore a state saved by ``save_train_state`` into ``state`` (a
    ``TrainState`` of the same model and optimizer) and return it."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(ck["model"])
    state.optimizer.load_state_dict(ck["optimizer"])
    state.step = int(ck["step"])
    return state


def _sharded_state(state) -> dict:
    """The model's and optimizer's state keyed by parameter name
    (``torch.distributed.checkpoint.state_dict.get_state_dict``), and the
    step."""
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model, optim = get_state_dict(state.model, state.optimizer)
    return {"model": model, "optimizer": optim, "step": torch.tensor(state.step)}


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step}")


def save_train_state_sharded(directory: str, state, step: int) -> None:
    """Save a ``train.loop.TrainState`` (model, optimizer and step) with
    ``torch.distributed.checkpoint`` under ``directory/step_{step}``: the
    counterpart of the JAX package's ``save_train_state_orbax``. Each rank
    of an initialised process group writes its own shards; without one the
    process writes the whole state."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_sharded_state(state), checkpoint_id=_step_dir(directory, step))


def load_train_state_sharded(directory: str, state, step: int):
    """Restore a state saved by ``save_train_state_sharded`` at ``step``
    into ``state`` (a ``TrainState`` of the same model and optimizer), in
    place, and return it: the counterpart of ``load_train_state_orbax``."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import set_state_dict

    sd = _sharded_state(state)
    dcp.load(sd, checkpoint_id=_step_dir(directory, step))
    set_state_dict(state.model, state.optimizer, model_state_dict=sd["model"], optim_state_dict=sd["optimizer"])
    state.step = int(sd["step"])
    return state
