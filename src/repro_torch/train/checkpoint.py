"""Checkpointing: flat-path ``.npz`` snapshots of tensor trees.
Counterpart of ``repro/train/checkpoint.py``.

This doubles as the paper's SSD weight channel (§3.3.1): the update
process drops weights to disk and the eval / visualization consumers pick
them up without ever blocking the updater. The file layout is the
reference's: one array a leaf under its ``"/"``-joined key path (``l0/w``,
``l0/b``, ...) and a JSON ``__meta__`` string, so a file written by
either package restores on the other.

Trees are nested dicts (and tuples or lists) of tensors, or one tensor.
"""
from __future__ import annotations

import errno
import json
import os
import tempfile
import time
from typing import Any, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch


class CheckpointError(RuntimeError):
    """A checkpoint file disagrees with the structure being restored.

    Carries the offending keys: ``missing`` (the target expects them,
    the file lacks them), ``unexpected`` (the file has them, the target
    does not) and ``mismatched`` (a stored shape or dtype that cannot
    restore into the target leaf; ``"key: ..."`` strings)."""

    def __init__(self, msg: str, *, missing: Sequence[str] = (),
                 unexpected: Sequence[str] = (),
                 mismatched: Sequence[str] = ()):
        super().__init__(msg)
        self.missing = tuple(missing)
        self.unexpected = tuple(unexpected)
        self.mismatched = tuple(mismatched)


#: OSError errnos that retrying cannot heal: permission, path and usage
#: errors stay wrong however long the disk is given to settle.
_NONTRANSIENT_ERRNOS = frozenset({
    errno.EACCES, errno.EPERM, errno.EROFS, errno.ENOENT, errno.ENOTDIR,
    errno.EISDIR, errno.EINVAL, errno.ENAMETOOLONG, errno.ELOOP,
})


def _transient_oserror(e: OSError) -> bool:
    """Busy-disk errors (EAGAIN, EBUSY, EIO, ENOSPC, or none given) are
    worth retrying; configuration errors are not."""
    return e.errno not in _NONTRANSIENT_ERRNOS


def _leaves(tree, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) in the tree's order; dict keys and sequence
    indices joined by ``"/"``, as the reference names them."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _rebuild(tree, leaves: Iterator):
    """``tree``'s structure with its leaves taken from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _flatten(tree) -> Dict[str, np.ndarray]:
    """Key path -> host array. A tensor on the card is copied on the
    current stream, which waits for it."""
    return {k: leaf.detach().cpu().numpy() if torch.is_tensor(leaf)
            else np.asarray(leaf) for k, leaf in _leaves(tree)}


def save(path: str, tree, metadata: Dict[str, Any] | None = None, *,
         retries: int = 3, backoff_s: float = 0.05) -> None:
    """Atomic save: write a temp file, then rename it over ``path``, so a
    concurrent reader never sees a torn file (what the SSD weight channel
    relies on). A failed write unlinks its temp file.

    A transient ``OSError`` (a busy disk) is retried up to ``retries``
    times with exponential backoff; a non-transient one (bad path,
    permissions) raises at once."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    for attempt in range(retries + 1):
        try:
            _save_once(path, flat, metadata)
            return
        except OSError as e:
            if not _transient_oserror(e) or attempt >= retries:
                raise
            time.sleep(backoff_s * (2 ** attempt))


def _save_once(path: str, flat: Dict[str, np.ndarray],
               metadata: Dict[str, Any] | None) -> None:
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, __meta__=json.dumps(metadata or {}), **flat)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


def restore(path: str, like) -> Tuple[Any, Dict[str, Any]]:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf lands on its ``like`` leaf's device and dtype (a copy to the
    card runs on the current stream).

    Raises :class:`CheckpointError` when the file's key set, or a stored
    leaf's shape or dtype kind, disagrees with ``like``. A same-kind
    width cast (a float64 file into a float32 leaf) is allowed."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        flat = {k: data[k] for k in data.files if k != "__meta__"}
    ref = list(_leaves(like))
    keys = {k for k, _ in ref}
    if keys != set(flat):
        missing = sorted(keys - set(flat))
        unexpected = sorted(set(flat) - keys)
        raise CheckpointError(
            f"checkpoint {path!r} keys mismatch: "
            f"missing={missing} unexpected={unexpected}",
            missing=missing, unexpected=unexpected)
    mismatched, out = [], []
    for key, leaf in ref:
        stored = flat[key]
        want_shape = tuple(leaf.shape)
        want_dtype = _np_dtype(leaf.dtype)
        if tuple(stored.shape) != want_shape:
            mismatched.append(f"{key}: shape {want_shape} != stored "
                              f"{tuple(stored.shape)}")
        elif (stored.dtype != want_dtype
              and stored.dtype.kind != want_dtype.kind):
            # a cross-kind cast (a float row into an int cursor) is
            # corruption
            mismatched.append(f"{key}: dtype {want_dtype} incompatible "
                              f"with stored {stored.dtype}")
        else:
            out.append(torch.from_numpy(stored).to(device=leaf.device,
                                                   dtype=leaf.dtype))
    if mismatched:
        raise CheckpointError(
            f"checkpoint {path!r} leaf mismatch: " + "; ".join(mismatched),
            mismatched=mismatched)
    return _rebuild(like, iter(out)), meta


def latest_step(ckpt_dir: str) -> int:
    """Highest step index among step_<n>.npz files (-1 if none)."""
    if not os.path.isdir(ckpt_dir):
        return -1
    steps = [-1]
    for f in os.listdir(ckpt_dir):
        if f.startswith("step_") and f.endswith(".npz"):
            try:
                steps.append(int(f[5:-4]))
            except ValueError:
                pass
    return max(steps)
