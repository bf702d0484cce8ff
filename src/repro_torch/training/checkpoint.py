"""Atomic, restartable checkpoints of tensor trees, in numpy files.

The JAX package's layout, one directory per step:

    <dir>/step_000123/
        manifest.json       leaf paths and dtypes, step, extra
        shard_<i>.npz       flat leaves, ~512 MB a file
    <dir>/LATEST            atomic pointer (written last)

  * atomic publish: the data is written and fsynced before ``LATEST``
    flips, so a crash mid-save never corrupts the restore point;
  * async save: :func:`save_async` copies to the host now and writes on a
    worker thread.

A tree is dicts, lists and tuples of tensors (numpy arrays and scalars
are taken too). It is flattened in a fixed order: dict keys sorted, as
the JAX package's ``tree_flatten`` orders them, lists and tuples in
order. ``bfloat16`` has no numpy dtype, so a bf16 leaf is stored as its
``int16`` bit pattern; the manifest records every leaf's dtype
(``"dtypes"``), and :func:`restore` views the bits back. Restore loads
into the structure of a like-tree, each tensor on its like-leaf's device.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading

import numpy as np
import torch

_MAX_SHARD_BYTES = 512 * 1024**2


def _flatten(tree, path="") -> list:
    """[(path, leaf)] in the fixed order (dict keys sorted; None is an
    empty subtree, as in JAX)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in
                _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in
                _flatten(v, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(like, leaves):
    """A tree shaped like ``like`` from an iterator of leaves."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: None for k in like}
        for k in sorted(like):
            out[k] = _unflatten(like[k], leaves)
        return out
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf) -> tuple:
    """(numpy array, dtype name) of a leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy().copy(), name
    a = np.asarray(leaf)
    return a, a.dtype.name


def _host(tree) -> tuple:
    flat = _flatten(tree)
    host = [_to_host(leaf) for _, leaf in flat]
    return ([a for a, _ in host], [p for p, _ in flat],
            [d for _, d in host])


def save(ckpt_dir: str, step: int, tree, extra: dict | None = None):
    """Blocking save of a tree of tensors."""
    host, paths, dtypes = _host(tree)
    _write(ckpt_dir, step, host, paths, dtypes, extra or {})


_PENDING: list = []
# Disk writes run one at a time, so async saves publish in the order they
# took the lock and never race on the pointer file.
_WRITE_LOCK = threading.Lock()


def save_async(ckpt_dir: str, step: int, tree, extra: dict | None = None):
    """Device -> host copy now; disk write on a daemon thread."""
    host, paths, dtypes = _host(tree)          # the sync point
    t = threading.Thread(
        target=_write, args=(ckpt_dir, step, host, paths, dtypes,
                             extra or {}), daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    for t in _PENDING:
        t.join()
    _PENDING.clear()


def _jsonable(obj):
    """Manifest-safe ``extra``: numpy scalars/arrays (and tensors) ->
    python natives, so ``json.dump`` takes per-slot bookkeeping."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _write(ckpt_dir: str, step: int, host_leaves, paths, dtypes, extra):
    with _WRITE_LOCK:
        _write_locked(ckpt_dir, step, host_leaves, paths, dtypes, extra)


def _write_locked(ckpt_dir, step, host_leaves, paths, dtypes, extra):
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_save_")
    try:
        shards, cur, cur_bytes = [], {}, 0
        for i, arr in enumerate(host_leaves):
            cur[f"leaf_{i}"] = arr
            cur_bytes += arr.nbytes
            if cur_bytes >= _MAX_SHARD_BYTES:
                shards.append(cur)
                cur, cur_bytes = {}, 0
        if cur:
            shards.append(cur)
        for si, shard in enumerate(shards):
            np.savez(os.path.join(tmp, f"shard_{si}.npz"), **shard)
        manifest = {
            "step": step,
            "paths": paths,
            "dtypes": dtypes,
            "n_leaves": len(host_leaves),
            "n_shards": len(shards),
            "extra": _jsonable(extra),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        # Atomic pointer flip: the publish step.
        ptr = os.path.join(ckpt_dir, "LATEST")
        with open(ptr + ".tmp", "w") as f:
            f.write(os.path.basename(final))
            f.flush()
            os.fsync(f.fileno())
        os.replace(ptr + ".tmp", ptr)
    except (KeyboardInterrupt, SystemExit):
        # Propagate at once; the orphaned tmp dir is harmless (LATEST
        # never points at it).
        raise
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def latest_step(ckpt_dir: str) -> int | None:
    ptr = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(ckpt_dir, name, "manifest.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["step"]


def _from_host(arr: np.ndarray, dtype: str | None, like):
    """A stored leaf back in the like-leaf's kind: a tensor of the saved
    dtype on the like-leaf's device, or a numpy array."""
    if not isinstance(like, torch.Tensor):
        return arr
    # ascontiguousarray gives a 0-d array one dimension; keep its shape.
    t = torch.from_numpy(np.ascontiguousarray(arr).reshape(arr.shape))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def restore(ckpt_dir: str, like_tree, step: int | None = None) -> tuple:
    """Restore into the structure of ``like_tree``; returns (tree,
    manifest). Each tensor lands on its like-leaf's device."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for si in range(manifest["n_shards"]):
        with np.load(os.path.join(d, f"shard_{si}.npz")) as z:
            flat.update({k: z[k] for k in z.files})
    likes = [leaf for _, leaf in _flatten(like_tree)]
    if len(likes) != manifest["n_leaves"]:
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"the like-tree {len(likes)}")
    dtypes = manifest.get("dtypes") or [None] * len(likes)
    leaves = [_from_host(flat[f"leaf_{i}"], dtypes[i], likes[i])
              for i in range(len(likes))]
    return _unflatten(like_tree, iter(leaves)), manifest
