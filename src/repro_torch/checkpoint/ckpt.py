"""Fault-tolerant checkpointing: atomic, self-describing, resumable.

Counterpart of ``repro.checkpoint.ckpt``, with the same on-disk layout, so
either package restores the other's checkpoints:

    <dir>/step_000000123/
        manifest.json     — step, tree description, leaf names, dtypes, extras
        arrays.npz        — flat leaf arrays (npz is zip: per-leaf entries)
    <dir>/step_000000123.COMMITTED   — commit marker

Write protocol: serialize into ``step_X.tmp/``, fsync, atomically rename
to ``step_X/``, then create the COMMITTED marker.  A crash at any point
leaves either a fully-committed checkpoint or ignorable garbage;
``latest_step`` only considers committed steps.

Leaf names join dict keys (sorted, as JAX flattens dicts), NamedTuple
field names and sequence indices with ``/``, as the reference names them.
bfloat16 is stored as uint16 with the dtype tag ``"bfloat16"``.  The
manifest's ``treedef`` is the reference's repr of a JAX treedef; no
``restore`` reads it, and the port writes its own description of the tree
there (``tree.describe``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import describe, tree_flatten_with_names, tree_unflatten

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array, dtype tag) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _to_tensor(arr: np.ndarray, tag: str, device) -> torch.Tensor:
    if tag == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def save(directory: str, step: int, tree, extras: Optional[Dict] = None
         ) -> str:
    """Atomically write checkpoint for ``step``; returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    named = tree_flatten_with_names(tree)
    arrays = {}
    dtypes = {}
    for name, leaf in named:
        arrays[name], dtypes[name] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)

    manifest = {
        "step": step,
        "treedef": describe(tree),
        "names": [n for n, _ in named],
        "dtypes": dtypes,
        "extras": extras or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())

    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(final + ".COMMITTED", "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    return final


def latest_step(directory: str) -> Optional[int]:
    """Highest committed step, or None."""
    if not os.path.isdir(directory):
        return None
    best = None
    for entry in os.listdir(directory):
        m = _STEP_RE.match(entry)
        if m and os.path.exists(os.path.join(directory, entry + ".COMMITTED")):
            s = int(m.group(1))
            best = s if best is None else max(best, s)
    return best


def restore(directory: str, step: int, like, device="cuda"
            ) -> Tuple[Any, Dict]:
    """Restore the checkpoint into the structure of ``like`` (a tree of
    tensors, possibly on the ``meta`` device) on ``device``; returns
    (tree, extras).  Dtypes are the checkpoint's."""
    final = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = []
    with np.load(os.path.join(final, "arrays.npz")) as data:
        for name, leaf in tree_flatten_with_names(like):
            arr = data[name]
            expect = tuple(leaf.shape)
            if tuple(arr.shape) != expect:
                raise ValueError(
                    f"checkpoint leaf {name}: shape {arr.shape} != {expect}")
            leaves.append(_to_tensor(arr, manifest["dtypes"][name], device))
    return tree_unflatten(like, leaves), manifest["extras"]


def restore_latest(directory: str, like, device="cuda"
                   ) -> Optional[Tuple[int, Any, Dict]]:
    step = latest_step(directory)
    if step is None:
        return None
    tree, extras = restore(directory, step, like, device)
    return step, tree, extras


def prune(directory: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed checkpoints."""
    if not os.path.isdir(directory):
        return
    steps = sorted(
        int(m.group(1)) for e in os.listdir(directory)
        if (m := _STEP_RE.match(e))
        and os.path.exists(os.path.join(directory, e + ".COMMITTED")))
    for s in steps[:-keep] if keep else steps:
        path = os.path.join(directory, f"step_{s:09d}")
        shutil.rmtree(path, ignore_errors=True)
        try:
            os.remove(path + ".COMMITTED")
        except OSError:
            pass
