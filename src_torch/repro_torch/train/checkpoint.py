"""npz checkpoints in the reference's store format.

Port of ``repro.train.checkpoint``.  The format is the reference's, byte
for byte in what matters, so each package loads the other's stores:

* a nested dict/list state is flattened to path keys written the way
  ``jax.tree_util.keystr`` writes them (``"['U']"``, ``"['a'][0]"``),
  dict keys in sorted order;
* every file embeds a sha256 over its arrays (key, dtype, shape, raw
  bytes; :func:`content_hash`) under ``HASH_KEY``;
* writes are atomic: ``np.savez`` into a ``*.tmp`` file in the store,
  then ``os.replace`` onto ``step_XXXXXXXX.npz``, so a crash leaves a
  tmp file and never a truncated step; ``available_steps`` ignores tmp
  files;
* the fault hook (``_fault_hook``, armed only by :mod:`repro_torch.faults`)
  fires ``"pre_rename"`` between the write and the rename.

Loaded arrays come back as CPU tensors; callers move them where they
serve.  A bfloat16 tensor is written as its 2-byte words (``|V2``), the
form an npz file gives back for the reference's ``ml_dtypes.bfloat16``
arrays, and read back as bfloat16.  A corrupt or truncated step raises
:class:`CheckpointCorruptError` naming it, and loading "the latest"
skips such steps with a warning.
"""
from __future__ import annotations

import hashlib
import os
import re
import tempfile
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

# sha256 hex digest of the checkpoint's arrays, stored as one more npz
# entry — excluded from the returned state and from its own digest
HASH_KEY = "__checkpoint_hash__"

# Test-only injection point (``repro_torch.faults``): when set, called as
# ``hook(event, **info)`` at named crash sites ("pre_rename" fires
# between the npz write and the atomic rename; the solve driver fires
# "segment_saved" after a segment's store write).  None in production.
_fault_hook: Optional[Callable[..., None]] = None


def _fire(event: str, **info) -> None:
    if _fault_hook is not None:
        _fault_hook(event, **info)


class CheckpointError(Exception):
    """A checkpoint could not be read or written."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint file exists but its bytes are unreadable or its
    content hash does not match — truncated write, bit rot, or a
    tampered store.  ``step`` and ``path`` name the offender."""

    def __init__(self, msg: str, step: Optional[int] = None,
                 path: Optional[str] = None):
        super().__init__(msg)
        self.step = step
        self.path = path


_BF16_WORDS = np.dtype("V2")


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(_BF16_WORDS)
        return leaf.numpy()
    return np.asarray(leaf)


def _as_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)
    if arr.dtype == _BF16_WORDS:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree, prefix: str = "", out: Optional[Dict] = None) -> Dict:
    """Path-keyed arrays, keys spelled as ``jax.tree_util.keystr``."""
    out = {} if out is None else out
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{prefix}[{k!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}[{i}]", out)
    else:
        out[prefix] = _as_numpy(tree)
    return out


_KEY_RE = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: dict = {}
    for key, arr in flat.items():
        parts = [m.group(1) if m.group(1) is not None else int(m.group(2))
                 for m in _KEY_RE.finditer(key)]
        cur = tree
        for k in parts[:-1]:
            cur = cur.setdefault(k, {})
        cur[parts[-1]] = _as_tensor(arr)
    return _listify(tree)


def _listify(node):
    """Convert dicts with contiguous int keys back into lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        idx = sorted(node)
        if idx == list(range(len(idx))):
            return [node[i] for i in idx]
    return node


def content_hash(flat: Dict[str, Any]) -> str:
    """sha256 over the flat array dict, key-sorted: the digest covers
    each entry's key, dtype, shape and raw bytes, so a reordered,
    reshaped, retyped or bit-flipped array all change the hash."""
    h = hashlib.sha256()
    for key in sorted(k for k in flat if k != HASH_KEY):
        arr = np.ascontiguousarray(_as_numpy(flat[key]))
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(repr(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.npz")


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    keep: Optional[int] = 3) -> str:
    """Atomically write ``state`` as ``step``; keep the newest ``keep``
    steps (``None`` keeps every step, the model-store convention)."""
    if keep is not None and keep < 1:
        raise ValueError(f"keep={keep} must be >= 1 (or None)")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _step_path(ckpt_dir, step)
    flat = _flatten(state)
    digest = content_hash(flat)
    flat[HASH_KEY] = np.frombuffer(digest.encode(), np.uint8).copy()
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    _fire("pre_rename", step=step, path=path, tmp=tmp)
    os.replace(tmp, path)
    if keep is not None:
        _gc(ckpt_dir, keep)
    return path


def _load_step(ckpt_dir: str, step: int) -> Any:
    """Read + verify ONE checkpoint file; CheckpointCorruptError names
    the step on any unreadable bytes or hash mismatch."""
    path = _step_path(ckpt_dir, step)
    try:
        with np.load(path) as data:
            flat = {k: data[k] for k in data.files}
    except FileNotFoundError:
        raise
    except Exception as e:      # zipfile.BadZipFile, OSError, ValueError...
        raise CheckpointCorruptError(
            f"checkpoint step {step} ({path}) is unreadable "
            f"(truncated or corrupt npz): {type(e).__name__}: {e}",
            step=step, path=path) from e
    stored = flat.pop(HASH_KEY, None)
    if stored is not None:
        want = bytes(np.asarray(stored)).decode(errors="replace")
        got = content_hash(flat)
        if got != want:
            raise CheckpointCorruptError(
                f"checkpoint step {step} ({path}) fails its content-hash "
                f"check (stored {want[:12]}…, recomputed {got[:12]}…) — "
                f"corrupt or tampered store", step=step, path=path)
    # pre-hash checkpoints (older stores) carry no digest; accepted as-is
    return _unflatten(flat)


def load_checkpoint(ckpt_dir: str, step: Optional[int] = None
                    ) -> Tuple[int, Any]:
    """Load a checkpoint, verifying its embedded content hash.

    ``step`` given: load exactly that step; a corrupt file raises
    :class:`CheckpointCorruptError` naming it.  ``step=None``: the
    newest step that verifies, skipping corrupt ones with a warning.
    """
    if step is not None:
        return step, _load_step(ckpt_dir, step)
    step_, tree, _ = load_latest_intact(ckpt_dir)
    return step_, tree


def load_latest_intact(ckpt_dir: str) -> Tuple[int, Any, List[int]]:
    """The newest checkpoint that verifies, plus the corrupt steps that
    were skipped on the way down (newest first)."""
    steps = available_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    skipped: List[int] = []
    last_err: Optional[CheckpointCorruptError] = None
    for s in reversed(steps):
        try:
            tree = _load_step(ckpt_dir, s)
        except CheckpointCorruptError as e:
            warnings.warn(f"skipping corrupt checkpoint: {e}")
            skipped.append(s)
            last_err = e
            continue
        return s, tree, skipped
    raise CheckpointCorruptError(
        f"no intact checkpoint in {ckpt_dir}: all of steps {steps} fail "
        f"verification (last: {last_err})")


def available_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in os.listdir(ckpt_dir):
        m = re.match(r"step_(\d+)\.npz$", f)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _gc(ckpt_dir: str, keep: int) -> None:
    for s in available_steps(ckpt_dir)[:-keep]:
        os.remove(_step_path(ckpt_dir, s))
