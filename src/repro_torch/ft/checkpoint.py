"""Fault-tolerant checkpointing: atomic step directories (port of
``repro.ft.checkpoint``, without jax).

The on-disk format is the reference's, so each side reads what the other
writes (``tests/test_torch_ft.py`` holds both directions):

  * atomic step directories: write to ``step_N.tmp`` then rename -- a crash
    mid-write never corrupts the latest checkpoint;
  * durable, ordered writes: every file lands via temp-file + flush +
    ``os.fsync`` + ``os.replace`` and the manifest is written LAST, so a
    manifest that exists implies its arrays are already durable; the
    containing directory is fsynced after each rename so the entries
    themselves survive power loss;
  * checked reads: a truncated or partial manifest (torn write, disk
    full) raises :class:`CheckpointCorruptError` by name instead of a
    bare ``JSONDecodeError`` deep in restore;
  * every leaf is saved with a manifest entry (tree path, shape, dtype) and
    its data in one ``arrays.npz``;
  * retention: keep the last K steps; partial (crashed) writes are
    garbage-collected after each save.

A tree is nested ``dict`` / ``list`` / ``tuple`` containers (``None`` holds
no leaf) whose leaves are numpy arrays, torch tensors or scalars. A leaf's
key is its path, dict keys and sequence indices joined by ``/``, dict keys
in sorted order, as the reference's jax pytree paths are. ``restore``
returns ``like``'s structure; a tensor leaf comes back with that leaf's
dtype and on its device. With ``shardings`` (the reference's elastic
re-shard) a leaf that has a ``dist.sharding.NamedSharding`` there comes
back placed on that mesh by its spec: the list of its blocks, one a
shard. The data is stored unsharded per leaf, so the saved mesh size is
irrelevant.

numpy has no bfloat16: a bf16 tensor leaf is stored losslessly as its
uint16 bit patterns, with ``"bfloat16"`` as its dtype in the manifest,
and comes back bit for bit. (The reference's reader sees those leaves as
uint16.) A training checkpoint (``launch/train.py``) holds the fp32
master parameters, the fp32 or int8 optimizer state, the error-feedback
residual ``grad_err`` under ``--compress-grads``, and the watchdog state
and data cursor in ``extra``.
"""
from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.dist import sharding

_STEP_RE = re.compile(r"^step_(\d+)$")
#: the manifest's dtype of a bf16 leaf, stored as its uint16 bits
BF16 = "bfloat16"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file exists but cannot be trusted: truncated or
    malformed manifest, or a manifest missing its required keys. Raised
    by name so callers can distinguish "this snapshot is damaged" (fall
    back to an older step, or refuse to resume) from "no snapshot"
    (FileNotFoundError)."""


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _durable_replace(part: str, dest: str) -> None:
    """Atomically publish ``part`` as ``dest`` and make both the data and
    the directory entry durable (fsync file, rename, fsync dir)."""
    os.replace(part, dest)
    _fsync_dir(os.path.dirname(dest))


def _write_durable(dest: str, mode: str, write) -> None:
    """Write ``dest`` through a fsynced ``.part`` file and its rename."""
    part = dest + ".part"
    with open(part, mode) as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    _durable_replace(part, dest)


def _load_manifest(final: str) -> dict:
    """Read + validate one step's manifest; truncated/partial manifests
    (torn write mid-crash) surface as :class:`CheckpointCorruptError`."""
    path = os.path.join(final, "manifest.json")
    try:
        with open(path, "rb") as f:
            raw = f.read()
        manifest = json.loads(raw.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"{path} is truncated or malformed ({e}); the step cannot be "
            f"trusted — fall back to an older step or delete it") from e
    if not isinstance(manifest, dict) or "arrays" not in manifest \
            or "step" not in manifest:
        raise CheckpointCorruptError(
            f"{path} parsed but is missing required keys "
            f"('step', 'arrays'): partial manifest from an interrupted "
            f"save — fall back to an older step or delete it")
    return manifest


def _flatten_with_paths(tree: Any, prefix: tuple = ()
                        ) -> list[tuple[str, Any]]:
    """(key, leaf) pairs in the reference's order: dict keys sorted,
    sequences by index, ``None`` an empty node."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [("/".join(str(p) for p in prefix), tree)]
    out = []
    for k, sub in items:
        out += _flatten_with_paths(sub, prefix + (k,))
    return out


def _unflatten(like: Any, leaves: dict[str, Any], prefix: tuple = ()) -> Any:
    """``like``'s structure with each leaf replaced by ``leaves[key]``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, prefix + (k,))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_unflatten(v, leaves, prefix + (i,))
               for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    return leaves["/".join(str(p) for p in prefix)]


def _is_bf16(leaf: Any) -> bool:
    return isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16


def _to_numpy(key: str, leaf: Any) -> np.ndarray:
    """The array stored for a leaf: a bf16 tensor as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if _is_bf16(t):
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray, saved: str, like: torch.Tensor
               ) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype on its device."""
    if saved == BF16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3,
         extra: Optional[dict] = None) -> str:
    """Atomically save a tree of numpy arrays and torch tensors."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "arrays": [], "extra": extra or {}}
    arrays = {}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        arr = _to_numpy(key, leaf)
        name = f"a{i}"
        manifest["arrays"].append({"key": key, "name": name,
                                   "shape": list(arr.shape),
                                   "dtype": BF16 if _is_bf16(leaf)
                                   else str(arr.dtype)})
        arrays[name] = arr
    # Arrays first, manifest LAST, every file fsynced before its rename:
    # a manifest that exists implies its arrays are already durable, so
    # readers never see a step whose data lags its metadata.
    _write_durable(os.path.join(tmp, "arrays.npz"), "wb",
                   lambda f: np.savez(f, **arrays))  # repro_torch: noqa[durable-write]: writes into the .part file that _write_durable opens, fsyncs and renames
    _write_durable(os.path.join(tmp, "manifest.json"), "w",
                   lambda f: json.dump(manifest, f))  # repro_torch: noqa[durable-write]: writes into the .part file that _write_durable opens, fsyncs and renames; the manifest lands LAST
    if os.path.exists(final):
        # Re-saving an existing step must land the FRESH arrays. os.replace
        # cannot atomically replace a non-empty directory, so the old step
        # is first moved aside under a .tmp suffix (which _retain GCs like
        # any crashed partial write) and removed only after the rename. A
        # crash between the two renames leaves no step_N listed — never a
        # stale one masquerading as the new save.
        old = final + ".old.tmp"
        if os.path.exists(old):
            shutil.rmtree(old)
        os.replace(final, old)
        os.replace(tmp, final)
        shutil.rmtree(old, ignore_errors=True)
    else:
        os.replace(tmp, final)
    _fsync_dir(ckpt_dir)    # the step_N entry itself survives power loss
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)
    # GC half-written tmp dirs
    for d in os.listdir(ckpt_dir):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        m = _STEP_RE.match(d)
        if m and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(m.group(1)))
    return sorted(steps)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    """The saved manifest (tree paths/shapes/dtypes + the ``extra`` payload
    callers stash host-side state in: watchdog EWMA/events, engine bucket
    config).

    Raises :class:`CheckpointCorruptError` for a truncated or partial
    manifest rather than handing the caller half a JSON document."""
    return _load_manifest(os.path.join(ckpt_dir, f"step_{step}"))


def read_extra(ckpt_dir: str, step: int) -> dict:
    return read_manifest(ckpt_dir, step).get("extra", {})


def restore(ckpt_dir: str, step: int, like: Any,
            shardings: Any = None) -> Any:
    """Restore into the structure of ``like``: a tensor leaf comes back as a
    tensor of that leaf's dtype on its device, any other leaf as a numpy
    array of its dtype (or the saved dtype, where it has none). Where
    ``shardings`` (a tree of ``like``'s structure, ``None`` where a leaf
    is not placed) holds a ``NamedSharding`` for a leaf, the leaf comes
    back as its blocks on that mesh (``dist.sharding.device_put``)."""
    final = os.path.join(ckpt_dir, f"step_{step}")
    manifest = _load_manifest(final)
    data = np.load(os.path.join(final, "arrays.npz"))
    by_key = {e["key"]: data[e["name"]] for e in manifest["arrays"]}
    saved = {e["key"]: e["dtype"] for e in manifest["arrays"]}
    placed = dict(_flatten_with_paths(shardings))
    out = {}
    for key, leaf in _flatten_with_paths(like):
        if key not in by_key:
            raise KeyError(
                f"checkpoint {final} has no array for {key!r} — the saved "
                f"payload does not match the restore tree (e.g. resuming "
                f"--compress-grads from a checkpoint saved without the "
                f"grad_err residual); saved keys: "
                f"{sorted(by_key)[:8]}...")
        arr = by_key[key]
        if isinstance(leaf, torch.Tensor):
            out[key] = _to_tensor(arr, saved[key], leaf)
        else:
            if saved[key] == BF16:
                raise TypeError(f"checkpoint leaf {key!r} is bfloat16; "
                                f"restore it into a tensor leaf")
            out[key] = np.asarray(
                arr, leaf.dtype if hasattr(leaf, "dtype") else arr.dtype)
        if key in placed:
            out[key] = sharding.device_put(torch.as_tensor(out[key]),
                                           placed[key])
    return _unflatten(like, out)


def restore_latest(ckpt_dir: str, like: Any, shardings: Any = None
                   ) -> tuple[Optional[int], Any]:
    step = latest_step(ckpt_dir)
    if step is None:
        return None, like
    return step, restore(ckpt_dir, step, like, shardings)
