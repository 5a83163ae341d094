"""Checkpoints with atomic commit, in the reference's on-disk format.

Counterpart of ``repro/checkpoint/checkpointer.py``, and the same format,
so a checkpoint written by either package restores in the other:

    <dir>/step_<N>/manifest.json + one .npy per leaf

Each leaf is stored as its raw bytes (``uint8``), its shape and dtype
string in the manifest (bf16 as ``bfloat16``, which numpy cannot name
itself).  Leaves are named by their path in the tree as the reference's
``_key_str`` names them: dict keys, tuple and list indices and NamedTuple
field names joined by ``__`` (``"root"`` for a bare leaf); dict keys are
taken in sorted order, as ``jax.tree_util`` takes them.  Writes go to
``step_<N>.tmp`` and are renamed on completion, so a crash mid-save never
corrupts the latest checkpoint.  A tree is nested dicts, lists, tuples
and NamedTuples of tensors, numpy arrays and Python scalars.
"""
from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..tree import leaves_with_path, rebuild


def _key_str(path) -> str:
    return "__".join(path) or "root"


def _host(leaf):
    """(numpy array, dtype string) of one leaf; bf16 as its raw bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(ckpt_dir, step: int, tree, meta: Optional[dict] = None,
                    blocking: bool = True):
    """Write ``tree`` as step ``step`` under ``ckpt_dir``.  Device tensors
    are copied to the host first (a sync).  Returns the committed
    directory; with ``blocking=False`` the files are written by a thread,
    which is returned.  An existing step is kept as it is."""
    ckpt_dir = Path(ckpt_dir)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    if final.exists():
        return final
    tmp.mkdir(parents=True, exist_ok=True)
    manifest = {"step": step, "meta": meta or {}, "leaves": []}
    host_arrays = []
    for path, leaf in leaves_with_path(tree):
        name = _key_str(path)
        arr, dtype = _host(leaf)
        manifest["leaves"].append(
            {"key": name, "shape": list(arr.shape), "dtype": dtype})
        host_arrays.append((name, arr))

    def _write():
        for name, arr in host_arrays:
            np.save(tmp / f"{name}.npy",
                    np.ascontiguousarray(arr).view(np.uint8))
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        os.replace(tmp, final)  # atomic commit

    if blocking:
        _write()
        return final
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir) -> Optional[int]:
    """The largest committed step under ``ckpt_dir``, or None."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if not p.name.endswith(".tmp") and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _tensor(raw: np.ndarray, info: dict) -> torch.Tensor:
    if info["dtype"] == "bfloat16":
        bits = raw.view(np.int16).reshape(info["shape"]).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    arr = raw.view(np.dtype(info["dtype"])).reshape(info["shape"]).copy()
    return torch.from_numpy(arr)


def load_checkpoint(ckpt_dir, step: Optional[int], like_tree):
    """Load step ``step`` (the latest when None) into the structure of
    ``like_tree``, as host (CPU) tensors.  Shapes and dtypes come from
    the manifest.  Returns (tree, manifest)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    meta = {m["key"]: m for m in manifest["leaves"]}
    out = [_tensor(np.load(d / f"{_key_str(path)}.npy"),
                   meta[_key_str(path)])
           for path, _ in leaves_with_path(like_tree)]
    return rebuild(like_tree, iter(out)), manifest


def restore_sharded(ckpt_dir, step, like_tree, device=None):
    """:func:`load_checkpoint`, each leaf then placed on ``device`` (the
    reference places with its mesh's shardings; here every shard lives on
    one device).  Returns (tree, manifest)."""
    host, manifest = load_checkpoint(ckpt_dir, step, like_tree)
    if device is None:
        return host, manifest
    leaves = [x.to(device) for _, x in leaves_with_path(host)]
    return rebuild(host, iter(leaves)), manifest
