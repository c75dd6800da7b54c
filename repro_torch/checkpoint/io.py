"""Tree <-> disk checkpointing (npz, atomic rename, step-indexed), twin of ``repro.checkpoint.io``.

The file format is the reference's, byte for byte in its keys, so a
snapshot written by either package restores in the other:

* one ``step_{step:09d}.npz`` per step;
* '/'-joined keys: a dict entry by its key, a tuple or list item by its
  index, a ``NamedTuple`` field as ``.<field>`` (the reference's path
  of an attribute); ``None`` is an empty subtree and writes nothing;
* bfloat16 leaves, which npz cannot hold, as ``uint16`` bit views under
  the ``__bf16__/`` prefix.

Restore rebuilds into the caller's target tree (shapes checked), so it
is safe against refactors that only reorder dict keys.
"""

from __future__ import annotations

import os
import re
import tempfile
import zipfile

import numpy as np
import torch

from repro_torch.device import require_device

# npz cannot represent bfloat16; such leaves are stored as uint16 bit
# views under a marker prefix and re-viewed on restore.
_BF16_PREFIX = "__bf16__/"


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaves(tree, path: tuple = ()):
    """(key, leaf) pairs of ``tree`` in order, keyed as the reference keys them."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from _leaves(value, path + (str(key),))
    elif _is_namedtuple(tree):
        for field in tree._fields:
            yield from _leaves(getattr(tree, field), path + ("." + field,))
    elif isinstance(tree, (tuple, list)):
        for i, value in enumerate(tree):
            yield from _leaves(value, path + (str(i),))
    else:
        yield "/".join(path), tree


def _rebuild(tree, leaf_fn, path: tuple = ()):
    """``tree`` with every leaf replaced by ``leaf_fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _rebuild(value, leaf_fn, path + (str(key),)) for key, value in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, f), leaf_fn, path + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaf_fn, path + (str(i),)) for i, v in enumerate(tree))
    return leaf_fn("/".join(path), tree)


def _flatten(tree) -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                flat[_BF16_PREFIX + key] = leaf.view(torch.int16).numpy().view(np.uint16)
                continue
            flat[key] = leaf.numpy()
        else:
            flat[key] = np.asarray(leaf)
    return flat


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` as step ``step``: to a temporary file, then renamed into place."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    path = os.path.join(ckpt_dir, f"step_{step:09d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    return path


def _readable(path: str) -> bool:
    """True when the npz at ``path`` is a complete, CRC-clean archive.

    npz is a zip: a writer killed mid-write (or a non-atomic copy torn
    partway) leaves either no central directory or truncated members.
    ``testzip`` walks every member against its CRC, so both tears are
    caught; the snapshots are small, making the full scan cheap.
    """
    try:
        with zipfile.ZipFile(path) as z:
            return z.testzip() is None
    except (OSError, zipfile.BadZipFile):
        return False


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step whose file is actually restorable.

    Torn or partial writes are skipped, not raised: a server that crashed
    mid-checkpoint must come back on the previous good snapshot, and a
    stray ``.tmp`` from a killed writer never matches the pattern.
    """
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(
        (int(m.group(1)) for f in os.listdir(ckpt_dir)
         if (m := re.match(r"step_(\d+)\.npz$", f))),
        reverse=True,
    )
    for step in steps:
        if _readable(os.path.join(ckpt_dir, f"step_{step:09d}.npz")):
            return step
    return None


def restore_checkpoint(ckpt_dir: str, step: int, target, *,
                       device: str | torch.device = "cuda"):
    """Step ``step`` rebuilt into the structure of ``target``, its leaves on ``device``.

    Each leaf takes the dtype of the target's leaf at its key (a missing
    key raises ``KeyError``, a shape other than the target's
    ``ValueError``).
    """
    dev = require_device(device)
    path = os.path.join(ckpt_dir, f"step_{step:09d}.npz")
    with np.load(path) as data:
        flat = dict(data)

    def restore(key, leaf):
        like = torch.as_tensor(leaf)
        if _BF16_PREFIX + key in flat:
            arr = torch.from_numpy(flat[_BF16_PREFIX + key].view(np.int16)).view(torch.bfloat16)
        elif key in flat:
            arr = torch.tensor(flat[key])
        else:
            raise KeyError(f"checkpoint missing {key}")
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{key}: shape {tuple(arr.shape)} != target {tuple(like.shape)}")
        return arr.to(device=dev, dtype=like.dtype)

    return _rebuild(target, restore)
