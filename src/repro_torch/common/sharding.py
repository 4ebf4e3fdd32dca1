"""Logical-axis sharding rules, MaxText-style: the rules half of the
reference's ``common/sharding.py``.

Every parameter and activation is annotated with *logical* axis names; a
rules table maps logical names to mesh axes per mesh.  The rules run over a
``MeshSpec``, a plain description of axis names and sizes (the counterpart
of the reference's ``abstract_mesh``); a spec is a tuple with one entry a
dimension: a mesh-axis name, a tuple of names, or ``None`` (replicated).
Placing tensors on a real mesh waits for the distributed slice; in one
process ``constrain`` is the identity, as the reference's is on one device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Mapping, Sequence

# logical axis -> mesh axis (or tuple of mesh axes, or None = replicated)
# "batch" folds pod+data so multi-pod meshes scale batch across pods.
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "fsdp": ("pod", "data"),  # ZeRO-3 parameter sharding axis
    "embed": ("pod", "data"),  # 2D weight sharding: d_model dim over data (FSDP)
    "model": "model",
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": ("data", "model"),  # full EP: one/few experts per chip
    "seq": None,
    "seq_sharded": "model",  # SP: long-context KV sharding
    "layers": None,  # scanned-layer stack dim
    "opt_state": ("pod", "data", "model"),  # ZeRO: flat int8 moments over all
    "nodes": ("pod", "data", "model"),
    "edges": ("pod", "data", "model"),
    "nodes_sm": ("pod", "data"),  # small graphs: don't pay 256-way collectives
    "edges_sm": ("pod", "data"),
    "table_vocab": "model",  # recsys embedding tables sharded by row
    "candidates": "model",
    "blocks": ("pod", "data"),  # learned-index doc blocks
    "docs": ("pod", "data"),
    "terms": "model",
    None: None,
}

Spec = tuple  # one entry a dim: a mesh-axis name, a tuple of names, or None


@dataclass(frozen=True)
class MeshSpec:
    """Axis names and sizes of a device mesh, with no devices behind it."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"shape {self.axis_sizes} and names {self.axis_names} must align")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(shape: Sequence[int], names: Sequence[str]) -> MeshSpec:
    """MeshSpec((16, 16), ("data", "model")) from the reference's argument order."""
    return MeshSpec(tuple(names), tuple(int(s) for s in shape))


def resolve_axis(logical: str | None, mesh: MeshSpec, rules: Mapping[str, Any] | None = None) -> Any:
    rules = rules or DEFAULT_RULES
    target = rules.get(logical, None)
    names = set(mesh.axis_names)
    if target is None:
        return None
    if isinstance(target, tuple):
        present = tuple(a for a in target if a in names)
        if not present:
            return None
        return present if len(present) > 1 else present[0]
    return target if target in names else None


def spec_for_shape(
    logical_axes: Sequence[str | None],
    shape: Sequence[int],
    mesh: MeshSpec,
    rules: Mapping[str, Any] | None = None,
) -> Spec:
    """Divisibility-aware spec: mesh axes that don't divide a dim are dropped
    (trailing-first), and a mesh axis is never used twice in one spec (the
    first dim that claims it wins) — e.g. MQA's kv_heads=1 falls back to
    replicated, and MoE ('experts','embed','mlp') keeps experts on `model`
    and drops mlp's claim."""
    sizes = mesh.shape
    used: set[str] = set()
    entries: list[Any] = []
    for ax, dim in zip(logical_axes, shape):
        target = resolve_axis(ax, mesh, rules)
        if target is None:
            entries.append(None)
            continue
        t = (target,) if isinstance(target, str) else tuple(target)
        t = tuple(a for a in t if a not in used)
        while t:
            prod = 1
            for a in t:
                prod *= sizes[a]
            if dim % prod == 0:
                break
            t = t[:-1]
        if not t:
            entries.append(None)
            continue
        used.update(t)
        entries.append(t if len(t) > 1 else t[0])
    return tuple(entries)


def partition_spec(
    logical_axes: Sequence[str | None],
    mesh: MeshSpec,
    rules: Mapping[str, Any] | None = None,
) -> Spec:
    return tuple(resolve_axis(ax, mesh, rules) for ax in logical_axes)


def constrain(x, *logical_axes: str | None):
    """Activation sharding constraint by logical axes: the identity in one
    process, where there is no mesh to lay ``x`` out on."""
    return x
