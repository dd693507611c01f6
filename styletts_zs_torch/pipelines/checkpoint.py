"""Checkpoints and stage hand-offs with ``torch.save``.

Counterpart of ``styletts_zs_tpu/pipelines/checkpoint.py``
(``CheckpointManager``, ``save_params``, ``load_params``), for the port's
trees: nested dicts of tensors (the parameter dicts of
``pipelines.factory``, or ``{"g": ..., "d": ...}`` as stage 1 saves them).
Every tensor is saved from a CPU copy and read back with
``torch.load(weights_only=True)``; a save is synchronous and lands under
its final name only when written whole.  Orbax checkpoints of the JAX
package cannot be read here: a JAX tree reaches the port through
``pipelines.convert.convert_params``.
"""
from __future__ import annotations

import os
import shutil

import torch

TREE_FILE = "tree.pt"


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _save(path: str, tree) -> None:
    tmp = f"{path}.tmp"
    torch.save(_map(tree, lambda x: x.detach().cpu()), tmp)
    os.replace(tmp, path)


def _like(tree, like, where: str = ""):
    """``tree`` checked against ``like``'s keys and shapes, each tensor
    moved to its counterpart's device and dtype."""
    if isinstance(like, dict):
        if not isinstance(tree, dict) or tree.keys() != like.keys():
            raise KeyError(f"checkpoint tree at {where or '/'}: keys "
                           f"{sorted(tree) if isinstance(tree, dict) else tree}"
                           f" vs {sorted(like)}")
        return {k: _like(tree[k], v, f"{where}/{k}") for k, v in like.items()}
    if not isinstance(tree, torch.Tensor) or \
            tuple(tree.shape) != tuple(like.shape):
        got = tuple(tree.shape) if isinstance(tree, torch.Tensor) else tree
        raise ValueError(f"checkpoint leaf {where}: shape {got} vs "
                         f"{tuple(like.shape)}")
    return tree.to(like.device, like.dtype)


def _load(path: str, like=None):
    tree = torch.load(path, map_location="cpu", weights_only=True)
    return tree if like is None else _like(tree, like)


class CheckpointManager:
    """Numbered checkpoints in ``directory`` (``<step>/tree.pt``), the
    newest ``keep`` kept."""

    def __init__(self, directory: str, *, keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self.directory, d, TREE_FILE)))

    def save(self, step: int, tree) -> None:
        d = os.path.join(self.directory, str(step))
        os.makedirs(d, exist_ok=True)
        _save(os.path.join(d, TREE_FILE), tree)
        for old in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def restore(self, step: int | None = None, *, like=None):
        """The tree saved at ``step`` (the latest by default; None if there
        is none), on the CPU, or checked against ``like`` and placed as
        its tensors are."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return _load(os.path.join(self.directory, str(step), TREE_FILE), like)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Nothing to wait for: ``save`` returns when the file is written."""

    def close(self) -> None:
        """Nothing to release."""


def save_params(path: str, params) -> None:
    """One tree to one file (a stage hand-off), replacing what is there."""
    _save(os.path.abspath(path), params)


def load_params(path: str, like=None):
    """``save_params``' tree, on the CPU or placed as ``like``'s tensors."""
    return _load(os.path.abspath(path), like)
