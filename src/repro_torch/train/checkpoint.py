"""Checkpoints with atomic commit, async save and restore onto a device
(port of ``repro/train/checkpoint.py``, same on-disk layout).

Layout (one directory per step):

    <dir>/step_00000123/
        manifest.json       # step, structure, shapes/dtypes, extra
        arrays.npz          # one entry per leaf ("0", "1", ...)
    <dir>/LATEST            # text file: the committed step number

  * two-phase commit: a save writes ``step_X.tmp`` and renames it only
    when complete, then updates LATEST, so a crash mid-save never
    corrupts the restore point;
  * leaves are flattened as ``jax.tree_util`` flattens them: dict keys in
    sorted order, NamedTuples and tuples in order, ``None`` holds none.
    So a params tree written by either package restores in the other;
  * bf16 is stored as its uint16 byte view with the dtype ``"bfloat16"``
    in the manifest (through ``Tensor.view(torch.int16)``: npz has no
    bf16, and no ``ml_dtypes`` is needed);
  * a ``torch.Generator`` leaf is stored as its state bytes;
  * async mode hands the host arrays to one worker thread, so the train
    loop blocks only on the device-to-host copy, not on disk;
  * ``gc_old`` keeps the last n steps.
"""
from __future__ import annotations

import json
import os
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike

PyTree = Any

_EXECUTOR = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> Optional[List]:
    """The children of a container in flattening order, None for a leaf."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(tree)
    return None


def tree_flatten(tree: PyTree) -> List:
    """The leaves of ``tree`` in ``jax.tree_util`` order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_flatten(kid)]


def _describe(tree: PyTree) -> str:
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        name = type(tree).__name__ if _is_namedtuple(tree) else ""
        return name + "(" + ", ".join(_describe(k) for k in tree) + ")"
    return "*"


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Generator):
        leaf = leaf.get_state()
    if torch.is_tensor(leaf):
        # analysis: host-sync ok -- checkpoint save copies the state to the host
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            # analysis: host-sync ok -- checkpoint save: a host tensor's numpy view
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()  # analysis: host-sync ok -- checkpoint save: a host tensor's numpy view
    return np.asarray(leaf)  # analysis: host-sync ok -- checkpoint save of a host leaf


def _dtype_name(leaf, host: np.ndarray) -> str:
    if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(host.dtype)


def save(directory: str, step: int, tree: PyTree, extra: Optional[dict] = None,
         async_: bool = False) -> Optional[Future]:
    """Checkpoint ``tree`` at ``step``. Returns a Future in async mode."""
    leaves = tree_flatten(tree)
    host = [_to_host(x) for x in leaves]
    manifest = {
        "step": int(step),
        "treedef": _describe(tree),
        "n_leaves": len(host),
        "shapes": [list(a.shape) for a in host],
        "dtypes": [_dtype_name(x, a) for x, a in zip(leaves, host)],
        "extra": extra or {},
    }

    def _commit():
        os.makedirs(directory, exist_ok=True)
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **{str(i): a for i, a in enumerate(host)})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        for attempt in range(3):            # atomic commit (retry a
            try:                            # concurrent-recreate race)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                break
            except OSError:
                if attempt == 2:
                    raise
        latest_tmp = os.path.join(directory, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(str(step))
        os.replace(latest_tmp, os.path.join(directory, "LATEST"))
        return final

    if async_:
        return _EXECUTOR.submit(_commit)
    _commit()
    return None


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _rebuild(like: PyTree, arrays: Iterator[np.ndarray], device) -> PyTree:
    if like is None:
        return None
    if isinstance(like, torch.Generator):
        # a generator's state is device-type specific: it stays on its
        # like's device
        g = torch.Generator(device=like.device)
        g.set_state(next(arrays))
        return g
    kids = _children(like)
    if kids is None:
        a = next(arrays)
        if torch.is_tensor(like):
            return a.to(device=like.device if device is None else device,
                        dtype=like.dtype)
        # analysis: host-sync ok -- checkpoint restore of a host scalar leaf
        return type(like)(a.item())
    if isinstance(like, dict):
        return {k: _rebuild(like[k], arrays, device) for k in sorted(like)}
    out = [_rebuild(k, arrays, device) for k in kids]
    return type(like)(*out) if _is_namedtuple(like) else type(like)(out)


def restore(directory: str, like: PyTree, step: Optional[int] = None,
            device: DeviceLike = None) -> Tuple[PyTree, int]:
    """Restore into the structure and dtypes of ``like``, each leaf on
    ``device`` (default: the device of its ``like`` leaf). Returns (tree,
    step); ``step`` None takes the committed LATEST; a generator leaf is
    made on its ``like`` leaf's device. ``device`` is the counterpart of
    the reference's ``shardings=`` (elastic restore): a checkpoint holds
    the whole state (the Trainer gathers a model rank's shards before it
    saves), so a rank of any mesh restores the whole tree onto its device
    and cuts its shards from it (``dist.sharding.shard_state``). Only the
    structure and dtypes of ``like`` are read: it may be a rank's
    shards."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    n = manifest["n_leaves"]
    if n != len(tree_flatten(like)):
        raise ValueError(f"checkpoint has {n} leaves, the structure "
                         f"{len(tree_flatten(like))}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = []
        for i in range(n):
            # analysis: host-sync ok -- checkpoint restore reads the host archive
            a = np.array(data[str(i)])
            if manifest["dtypes"][i] == "bfloat16":
                arrays.append(torch.from_numpy(a.view(np.int16)).view(torch.bfloat16))
            else:
                arrays.append(torch.from_numpy(a))
    return _rebuild(like, iter(arrays), device), step


def gc_old(directory: str, keep_last_n: int = 3) -> None:
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(d.split("_")[1])
        for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp")
    )
    for s in steps[:-keep_last_n]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
