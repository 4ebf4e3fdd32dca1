"""Production mesh builders.

Functions, not module constants: importing this module touches no process
group.  Planning code (``dryrun``'s shardings, the learned-index dry run)
uses ``mesh_config`` / ``MeshSpec`` and needs no world; a concrete mesh
needs an initialised world of its size.
"""
from __future__ import annotations

from repro_torch.common.config import MeshConfig
from repro_torch.common.sharding import MeshSpec, concrete_mesh


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) ``("data", "model")`` mesh of cards, or (2, 16, 16) with
    ``pod``: needs a world of 256 (512) ranks."""
    cfg = mesh_config(multi_pod)
    return concrete_mesh(cfg.shape, cfg.axes)


def make_host_mesh():
    """A (1, world) mesh of CPU ranks with the production axis names
    (tests, examples)."""
    import torch.distributed as dist

    return concrete_mesh((1, dist.get_world_size()), ("data", "model"), device_type="cpu")


def mesh_config(multi_pod: bool = False) -> MeshConfig:
    return (
        MeshConfig(shape=(2, 16, 16), axes=("pod", "data", "model"))
        if multi_pod
        else MeshConfig(shape=(16, 16), axes=("data", "model"))
    )


def production_spec(multi_pod: bool = False) -> MeshSpec:
    """The production mesh as a ``MeshSpec``, for planning without a world."""
    cfg = mesh_config(multi_pod)
    return MeshSpec(tuple(cfg.axes), tuple(cfg.shape))


def sharded_step_vs_one_process(cell, step, opt_cfg, model, batch: dict, mesh) -> dict:
    """One train ``step`` of ``model`` sharded on ``mesh`` by the cell's
    rules (its batch by the cell's input axes) against the same step of an
    unsharded copy on this rank, both from the same weights and batch.

    -> the two losses and gradient norms, the step's lr, and per leaf the
    largest gradient and parameter differences, the largest gradient, the
    share of parameter elements within 0.05 lr of the copy's, the leaf's
    size and its dtype, the largest difference of its first moment (int8
    moments dequantized) and the largest moment, and its moments' DTensor
    placements; and how many leaves the rules sharded.  ``model`` is left
    sharded."""
    import copy

    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.common.sharding import mesh_context, shard_module, sharding_for_shape
    from repro_torch.train.optimizer import dequantize_blockwise, init_adam

    plain = copy.deepcopy(model)
    shard_module(model, cell.param_axes, mesh)
    n_sharded = sum(any(p.is_shard() for p in t.placements) for t in model.parameters())
    sharded = {k: distribute_tensor(v, mesh, sharding_for_shape(cell.input_axes[k],
                                                                 tuple(v.shape), mesh))
               for k, v in batch.items()}
    opt = init_adam([p for _, p in sorted(model.named_parameters())], opt_cfg)
    with mesh_context(mesh):
        m = step(model, opt, sharded)
    m = {k: v.full_tensor() if isinstance(v, DTensor) else v for k, v in m.items()}
    plain_opt = init_adam([p for _, p in sorted(plain.named_parameters())], opt_cfg)
    pm = step(plain, plain_opt, batch)
    lr = float(pm["lr"])
    want = dict(plain.named_parameters())
    order = {name: i for i, (name, _) in enumerate(sorted(model.named_parameters()))}

    def moment(state, name, shape):
        mo = state.m[order[name]]
        mo = dequantize_blockwise(mo, shape) if isinstance(mo, dict) else mo
        return (mo.full_tensor() if isinstance(mo, DTensor) else mo).float()

    def placed(mo):
        if isinstance(mo, dict):
            return {k: [str(p) for p in v.placements] for k, v in mo.items()}
        return [str(p) for p in mo.placements]

    leaves = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            q = want[name]
            d_m = (moment(opt, name, tuple(p.shape)) - moment(plain_opt, name, tuple(q.shape)))
            d_p = (p.full_tensor().float() - q.float()).abs()
            g = p.grad.full_tensor().float() if p.grad is not None else torch.zeros_like(d_p)
            g_want = q.grad.float() if q.grad is not None else torch.zeros_like(d_p)
            leaves[name] = {"grad_diff": float((g - g_want).abs().max()),
                            "grad_max": float(g_want.abs().max()),
                            "param_diff": float(d_p.max()),
                            "within": float((d_p <= 0.05 * lr).float().mean()),
                            "numel": d_p.numel(),
                            "dtype": str(q.dtype).removeprefix("torch."),
                            "m_diff": float(d_m.abs().max()),
                            "m_max": float(moment(plain_opt, name, tuple(q.shape)).abs().max()),
                            "m_placements": placed(opt.m[order[name]])}
    return {"loss": [float(m["loss"]), float(pm["loss"])],
            "grad_norm": [float(m["grad_norm"]), float(pm["grad_norm"])], "lr": lr,
            "leaves": leaves, "sharded": [n_sharded, len(leaves)]}
