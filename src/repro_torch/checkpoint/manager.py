"""Fault-tolerant checkpointing on the reference's on-disk format.

  * ``step_%08d/`` holds ``shards.npz`` (every leaf's raw bytes as a uint8
    array ``leaf_<i>``) and ``manifest.json`` (paths, shapes, dtypes);
  * writes go to ``<dir>/tmp.<step>.<pid>`` then a single atomic
    ``os.rename`` to ``<dir>/step_<n>``: a crash mid-write never corrupts
    the latest checkpoint;
  * restore reads the leaves host-side and places them on ``device`` (or
    beside the leaf of ``like`` they replace), or lays them out on a device
    mesh by ``shardings`` (a matching tree of ``NamedSharding``): the mesh
    may differ from the one the checkpoint was written from (elastic
    scale up/down = reshard on load);
  * in a ``torch.distributed`` world every rank calls ``save_checkpoint``
    (a DTensor leaf is gathered whole, which is collective), rank 0 writes,
    and the others wait for it;
  * keep_last garbage-collects old steps, newest-first retention.

A tree is a state dict, or nested dicts, lists, tuples and dataclasses
(``AdamState``) of tensors, numpy arrays and Python numbers; ``None`` holds
no leaf.  Dict keys are taken in sorted order, as the reference flattens
dicts, so a flat dict of arrays written by either package restores in the
other.  bf16 round-trips through its bytes (``torch.frombuffer``), with no
``ml_dtypes``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Iterator

import numpy as np
import torch

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int64": torch.int64, "int32": torch.int32,
    "int16": torch.int16, "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _is_leaf(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float, bool))


def _children(tree: Any) -> list[tuple[str, Any]]:
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    raise TypeError(f"not a checkpoint tree node: {type(tree).__name__}")


def _flatten_with_paths(tree: Any, prefix: str = "", leaf: type | None = None
                        ) -> Iterator[tuple[str, Any]]:
    if tree is None:
        return
    if _is_leaf(tree) or (leaf is not None and isinstance(tree, leaf)):
        yield prefix, tree
        return
    for name, child in _children(tree):
        yield from _flatten_with_paths(child, f"{prefix}/{name}" if prefix else name, leaf)


def _rebuild(like: Any, leaves: Iterator[Any]) -> Any:
    if like is None:
        return None
    if _is_leaf(like):
        return next(leaves)
    if isinstance(like, dict):
        done = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return type(like)((k, done[k]) for k in like)
    if dataclasses.is_dataclass(like):
        return dataclasses.replace(
            like, **{f.name: _rebuild(getattr(like, f.name), leaves) for f in dataclasses.fields(like)})
    kids = [_rebuild(v, leaves) for v in like]
    if isinstance(like, tuple) and hasattr(like, "_fields"):  # NamedTuple
        return type(like)(*kids)
    return type(like)(kids)


def _world() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def _to_host(leaf: Any) -> tuple[bytes, list[int], str]:
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor

        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu().contiguous()
        name = _NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes(), list(t.shape), name
    a = np.asarray(leaf)
    return a.tobytes(), list(a.shape), str(a.dtype)


def _from_host(raw: bytes, shape: list[int], name: str, like: Any, device) -> Any:
    if name == "bfloat16" or isinstance(like, torch.Tensor):
        dtype = _TORCH_DTYPES[name]
        if len(raw):
            t = torch.frombuffer(bytearray(raw), dtype=dtype).reshape(shape)
        else:
            t = torch.empty(shape, dtype=dtype)
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else None)
        return t.to(dev) if dev is not None else t
    a = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy()
    if isinstance(like, bool):
        return bool(a)
    if isinstance(like, int):
        return int(a)
    if isinstance(like, float):
        return float(a)
    return a


def save_checkpoint(directory: str, step: int, tree: Any, *, extra: dict | None = None) -> str:
    flat = list(_flatten_with_paths(tree))
    final = os.path.join(directory, f"step_{step:08d}")
    # store raw bytes: numpy's npz cannot represent bf16 — the dtype lives
    # in the manifest and the bytes are reinterpreted on restore
    host = [_to_host(leaf) for _, leaf in flat]
    if _world():
        import torch.distributed as dist

        if dist.get_rank() == 0:
            _write(directory, step, flat, host, extra)
        dist.barrier()
        return final
    return _write(directory, step, flat, host, extra)


def _write(directory: str, step: int, flat: list, host: list, extra: dict | None) -> str:
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "shards.npz"),
             **{f"leaf_{i}": np.frombuffer(raw, dtype=np.uint8) for i, (raw, _, _) in enumerate(host)})
    manifest = {
        "step": step,
        "paths": [p for p, _ in flat],
        "shapes": [shape for _, shape, _ in host],
        "dtypes": [name for _, _, name in host],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(directory)
        if name.startswith("step_") and os.path.exists(os.path.join(directory, name, "manifest.json"))
    ]
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, like: Any, *,
                       device: str | torch.device | None = None, shardings: Any = None) -> Any:
    """Restore into the structure of ``like``.  Tensor leaves (and every bf16
    leaf) come back as tensors on ``device``, or on the device of the leaf of
    ``like`` they replace when ``device`` is None; numpy leaves as numpy
    arrays, Python numbers as Python numbers.  Dtypes are the checkpoint's.

    With ``shardings`` (a tree matching ``like`` of ``NamedSharding``), each
    leaf is read on the host and distributed by its placements over its
    mesh, whatever mesh it was saved from (every rank reads the file)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = [leaf for _, leaf in _flatten_with_paths(like)]
    n = len(manifest["dtypes"])
    if len(like_leaves) != n:
        raise ValueError(f"checkpoint has {n} leaves, target structure has {len(like_leaves)}")
    dev = torch.device(device) if device is not None else None
    with np.load(os.path.join(path, "shards.npz")) as data:
        leaves = [
            _from_host(data[f"leaf_{i}"].tobytes(), shp, dt, like_leaves[i], dev)
            for i, (dt, shp) in enumerate(zip(manifest["dtypes"], manifest["shapes"]))
        ]
    if shardings is not None:
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.common.sharding import NamedSharding

        placed = [s for _, s in _flatten_with_paths(shardings, leaf=NamedSharding)]
        if len(placed) != n:
            raise ValueError(f"{len(placed)} shardings for {n} leaves")
        leaves = [distribute_tensor(torch.as_tensor(leaf).to(sh.mesh.device_type), sh.mesh,
                                    sh.placements)
                  for leaf, sh in zip(leaves, placed)]
    return _rebuild(like, iter(leaves))


class CheckpointManager:
    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        out = save_checkpoint(self.directory, step, tree, extra=extra)
        self._gc()
        return out

    def restore_latest(self, like: Any, device: str | torch.device | None = None,
                       shardings: Any = None) -> tuple[int, Any] | None:
        step = latest_step(self.directory)
        if step is None:
            return None
        return step, restore_checkpoint(self.directory, step, like, device=device,
                                        shardings=shardings)

    def _gc(self):
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_")
        )
        for s in steps[: -self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
