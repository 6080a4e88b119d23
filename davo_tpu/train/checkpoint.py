"""Checkpoints as `.npz` files of a pytree's leaves, keyed by tree path.

A save writes the whole file under a temporary name, flushes it to disk
and renames it into place, so a reader sees either the previous
checkpoint or the new one, never a torn file. A restore needs a
template of the same structure: every path, shape and dtype must match,
or the restore is refused.
"""

from __future__ import annotations

import os
import re

import jax
import numpy as np

_CKPT = re.compile(r"^ckpt_(\d+)\.npz$")


def _flat(tree) -> dict[str, object]:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(path): leaf for path, leaf in leaves}


def save_tree(path: str, tree) -> None:
    """Write `tree`'s leaves to `path` atomically (temp file + rename)."""
    arrays = {k: np.asarray(v) for k, v in _flat(jax.device_get(tree)).items()}
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_tree(path: str, template):
    """Read `path` into the structure of `template` (host arrays)."""
    want = _flat(template)
    with np.load(path, allow_pickle=False) as z:
        got = {k: z[k] for k in z.files}
    if set(got) != set(want):
        missing = sorted(set(want) - set(got))[:3]
        extra = sorted(set(got) - set(want))[:3]
        raise ValueError(
            f"checkpoint {path} does not match the template: "
            f"missing {missing}, unexpected {extra}"
        )
    for k, t in want.items():
        t_shape = tuple(getattr(t, "shape", np.shape(t)))
        t_dtype = np.dtype(getattr(t, "dtype", None) or np.result_type(t))
        if got[k].shape != t_shape or got[k].dtype != t_dtype:
            raise ValueError(
                f"checkpoint {path}: {k} is {got[k].dtype}{got[k].shape}, "
                f"template wants {t_dtype}{t_shape}"
            )
    treedef = jax.tree_util.tree_structure(template)
    return jax.tree_util.tree_unflatten(treedef, [got[k] for k in want])


class CheckpointManager:
    """Numbered checkpoints `ckpt_<step>.npz` in one directory, keeping
    the newest `max_to_keep`."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def all_steps(self) -> list[int]:
        return sorted(
            int(m.group(1))
            for m in map(_CKPT.match, os.listdir(self.directory))
            if m
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree) -> None:
        save_tree(self._path(step), tree)
        for old in self.all_steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: int, template):
        return load_tree(self._path(step), template)
