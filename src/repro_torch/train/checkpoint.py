"""Checkpointing with async save and atomic commit, in the reference
package's file layout.

Layout: <dir>/step_<N>/
    manifest.json        tree structure, shapes, dtypes
    arr_<i>.npy          one file per leaf, in the order of
                         ``jax.tree.flatten`` (dict keys sorted, lists in
                         order; ``train.tree``)

Writes go to ``step_<N>.tmp``; the manifest is fsynced and the directory
renamed only then, so a crash mid-save never corrupts the latest
checkpoint (restore picks the newest committed step).
``AsyncCheckpointer`` copies the state to the host, then writes it on a
background thread while the train loop keeps stepping.

Files written by either package restore in the port.  bf16 leaves are
written with the bytes the reference writes: numpy has no bf16 type, and
an ml_dtypes bf16 array is saved with the descriptor ``<V2``, so the port
writes its bf16 bits under that descriptor.  Such a file loads as 2-byte
voids; ``restore`` reads them back as bf16 bits where the like-state leaf
is bf16.  The reference's own ``restore`` cannot read them
(``astype(bfloat16)`` on a ``V2`` array raises "No cast function
available"; ROADMAP queue 3).

``restore(shardings=)`` places each leaf on a live slot mesh by a tree of
``distributed.meshes.NamedSharding``s (``meshes.place``: a
``ShardedTensor``, whose slots on one device hold views of one tensor),
in the file's dtype, as the reference's ``device_put(arr, sharding)``
keeps it; bf16 bits read back as bf16.  ``fault_tolerance``'s
``elastic_reshard`` restores so onto a new mesh.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed import meshes
from repro_torch.train import tree

_BF16_DESCR = "<V2"


def _host(leaf: torch.Tensor):
    """(numpy array, dtype name) for a tensor leaf; bf16 as its int16
    bits."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _write_array(path, arr: np.ndarray, dtype: str):
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False,
                "shape": arr.shape})
        f.write(arr.tobytes())


def save(directory, step: int, state, extra: Optional[dict] = None):
    d = pathlib.Path(directory)
    tmp = d / f"step_{step}.tmp"
    final = d / f"step_{step}"
    if final.exists():
        return final
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    leaves, structure = tree.flatten(state)
    meta = {
        "step": step,
        "treedef": tree.describe(structure),
        "num_leaves": len(leaves),
        "leaves": [],
        "extra": extra or {},
    }
    for i, leaf in enumerate(leaves):
        arr, dtype = _host(leaf)
        _write_array(tmp / f"arr_{i}.npy", arr, dtype)
        meta["leaves"].append({"shape": list(arr.shape), "dtype": dtype})
    with open(tmp / "manifest.json", "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    tmp.rename(final)                      # atomic commit
    return final


def latest_step(directory) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = []
    for p in d.iterdir():
        if p.is_dir() and p.name.startswith("step_") and \
                not p.name.endswith(".tmp") and (p / "manifest.json").exists():
            steps.append(int(p.name.split("_")[1]))
    return max(steps) if steps else None


def _file_tensor(arr: np.ndarray) -> torch.Tensor:
    """A leaf in the file's own dtype: 2-byte voids are bf16 bits."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise TypeError(f"{arr.dtype}: only bf16 bits (<V2) are read")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _tensor(arr: np.ndarray, like: torch.Tensor, i: int) -> torch.Tensor:
    if arr.dtype.kind == "V" and like.dtype != torch.bfloat16:
        raise TypeError(f"leaf {i}: {arr.dtype} bits restore into a "
                        f"bf16 leaf only, not {like.dtype}")
    return _file_tensor(arr).to(device=like.device, dtype=like.dtype)


def restore(directory, step: int, like_state, shardings=None):
    """Restore into the structure of ``like_state`` (shapes checked).
    Without ``shardings`` each leaf takes its like leaf's dtype, device
    and ``requires_grad``.  With ``shardings`` (a tree of
    ``meshes.NamedSharding``s of the state's structure) each leaf keeps
    the file's dtype and is placed on its sharding's live mesh as a
    ``meshes.ShardedTensor``."""
    d = pathlib.Path(directory) / f"step_{step}"
    meta = json.loads((d / "manifest.json").read_text())
    leaves, structure = tree.flatten(like_state)
    if meta["num_leaves"] != len(leaves):
        raise ValueError(f"{d}: {meta['num_leaves']} leaves, the like "
                         f"state has {len(leaves)}")
    placed = None
    if shardings is not None:
        placed, _ = tree.flatten(shardings)
        if len(placed) != len(leaves):
            raise ValueError(f"{len(placed)} shardings for {len(leaves)} "
                             f"leaves")
    out = []
    for i, ref in enumerate(leaves):
        arr = np.load(d / f"arr_{i}.npy")
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{d}: leaf {i} has shape {arr.shape}, the "
                             f"like state {tuple(ref.shape)}")
        if placed is not None:
            out.append(meshes.place(_file_tensor(arr), placed[i]))
            continue
        t = _tensor(arr, ref, i)
        out.append(t.requires_grad_(ref.requires_grad))
    return tree.unflatten(structure, out)


def restore_latest(directory, like_state, shardings=None):
    s = latest_step(directory)
    if s is None:
        return None, None
    return restore(directory, s, like_state, shardings), s


class AsyncCheckpointer:
    """Background-thread checkpoint writer (one in flight at a time)."""

    def __init__(self, directory):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state, extra=None):
        self.wait()
        # snapshot to host before returning control to the train loop (the
        # optimizer updates the state's tensors in place)
        host_state = tree.map(lambda x: x.detach().to("cpu", copy=True),
                              state)

        def _work():
            try:
                save(self.directory, step, host_state, extra)
            except BaseException as e:      # noqa: BLE001
                self._error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
