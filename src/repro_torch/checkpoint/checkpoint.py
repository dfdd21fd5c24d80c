"""Fault-tolerant checkpointing: atomic, journaled, async-capable (port of
``repro/checkpoint/checkpoint.py``), in the JAX package's on-disk format.

Layout:  <dir>/step_<N:08d>/shard_0.npz  + manifest.json (journal)

  * names: each leaf is stored under its tree path as the JAX package
    names it (``jax.tree_util`` paths joined by ``/``): dict keys by
    name, list / tuple items and dataclass fields by position (``FLState``
    and ``SchedulerState`` keep the JAX field order), so a checkpoint
    written by either package restores in the other. bf16 leaves are
    stored as their ``uint16`` bits under ``name::bf16``; host leaves
    (``FLState.rng`` (2,) uint32, ``FLState.step`` as int32) as they are.
  * atomic: written to ``step_<N>.tmp`` then renamed, so a crash mid-save
    never corrupts the latest valid checkpoint.
  * journaled: ``manifest.json`` records the step and the names;
    ``latest_step`` takes the newest COMPLETE checkpoint, so a restart
    resumes from the last good round (``launch/train.py --resume``).
  * async: ``AsyncCheckpointer`` copies the state to host memory
    synchronously and writes it on a background thread.
  * rank-sharded: a state whose parameters and momentum are a rank's
    tensor-parallel blocks is saved whole (``fl.state.whole_state``
    gathers it over the model group; one rank writes), so the file is
    the single-process one; :func:`restore_rank` reads it whole on the
    host and keeps this rank's blocks.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch

_BF16 = "::bf16"


def _items(tree, prefix: str = ""):
    """(name, leaf) pairs in the JAX package's path naming; None is an
    empty subtree, as in ``jax.tree_util``."""
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], join(k))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _items(x, join(i))
    elif dataclasses.is_dataclass(tree):
        for i, f in enumerate(dataclasses.fields(tree)):
            yield from _items(getattr(tree, f.name), join(i))
    else:
        yield prefix, tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    if isinstance(leaf, (int, np.integer)):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _arrays(state) -> dict[str, np.ndarray]:
    out = {}
    for name, leaf in _items(state):
        arr = _to_numpy(leaf)
        bf16 = isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16
        out[name + _BF16 if bf16 else name] = arr
    return out


def _write(directory: str, step: int, arrays: dict[str, np.ndarray]) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "num_hosts": 1, "keys": sorted(arrays)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(directory: str, step: int, state: Any) -> str:
    """Synchronous atomic save. Returns the final checkpoint path."""
    return _write(directory, step, _arrays(state))


def latest_step(directory: str) -> int | None:
    """Newest step with a complete (manifest-bearing) checkpoint."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            best = max(best or 0, int(m.group(1)))
    return best


def _restore_leaf(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)
    if isinstance(like, (int, np.integer)):
        return int(arr)
    return np.asarray(arr, dtype=np.asarray(like).dtype).reshape(np.shape(like))


def _rebuild(like, data, prefix: str = ""):
    join = (lambda k: f"{prefix}/{k}") if prefix else str
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, data, join(k)) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, data, join(i)) for i, x in enumerate(like))
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), data, join(i))
            for i, f in enumerate(dataclasses.fields(like))})
    if prefix + _BF16 in data:
        bits = np.ascontiguousarray(data[prefix + _BF16]).view(np.int16)
        t = torch.from_numpy(bits).view(torch.bfloat16)
        return t.to(device=like.device, dtype=like.dtype).reshape(like.shape)
    return _restore_leaf(data[prefix], like)


def restore(directory: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: each tensor leaf in its
    dtype on its device, host leaves as host values."""
    path = os.path.join(directory, f"step_{step:08d}", "shard_0.npz")
    with np.load(path) as data:
        return _rebuild(like, data)


def restore_rank(directory: str, step: int, like, tp) -> Any:
    """Restore a whole ``FLState`` checkpoint into a rank's state ``like``
    whose parameters and momentum are its blocks under ``tp`` (a
    ``dist.tensor_parallel.TensorParallel``; None: :func:`restore`): the
    whole trees are read on the host, then this rank's blocks go to the
    blocks' device."""
    if tp is None:
        return restore(directory, step, like)
    from repro_torch import tree
    from repro_torch.fl.state import rank_state

    def host(local):
        return tree.unflatten(local, [
            torch.empty(tuple(d.shape), dtype=x.dtype)
            for x, d in zip(tree.leaves(local), tree.leaves(tp.decls))])

    mu = like.server_mu
    whole = dataclasses.replace(like, params=host(like.params),
                                server_mu=None if mu is None else host(mu))
    device = tree.leaves(like.params)[0].device
    return rank_state(restore(directory, step, whole), tp, device)


class AsyncCheckpointer:
    """Background-thread checkpointing: ``save`` copies the state to the
    host at once and writes it while training goes on; ``keep`` newest
    checkpoints are kept."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        snapshot = _arrays(state)  # device -> host, before training moves on

        def _run():
            try:
                _write(self.directory, step, snapshot)
                self._gc()
            except Exception as e:  # noqa: BLE001 - surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(m.group(1))
            for m in (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.directory))
            if m
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)
