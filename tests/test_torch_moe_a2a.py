"""Expert-parallel MoE with an explicit token all-to-all (``models/moe_a2a``)
against the reference on a (data 2, model 2) mesh, on the CPU.

One gloo world of 4 ranks runs every case once (a module-scoped fixture);
the reference runs the same numpy inputs once in a JAX subprocess with 8
host devices (4 of them in the mesh).  Reduced deepseek-v3 and -v2-lite,
with ``moe_aux_free`` on and off, at a capacity that drops slots and at one
that drops none.

Tolerance: the port runs each arrived row through its own expert, the
reference every row through every local expert; the products see other
row counts, so outputs agree within 1e-5 + 1e-4 relative (fp32).
"""
import itertools
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
ATOL, RTOL = 1e-5, 1e-4
B, S = 4, 16  # 32 tokens a data block: 16 a (data, model) rank, 32 top-2 slots
CASES = [f"{arch}-{aux}-{drop}" for arch, aux, drop in itertools.product(
    ("v3", "v2lite"), ("auxfree", "softmax"), ("drops", "dropless"))]
ARCH = {"v3": "deepseek-v3-671b", "v2lite": "deepseek-v2-lite-16b"}
# a capacity factor of 0.5 gives each (source, destination) 4 slots of ~8 routed
CF = {"drops": 0.5, "dropless": 1e9}
DISPATCH = CASES[:4:3]  # v3: aux-free with drops, softmax dropless


def _cfg(pkg, case: str, *, a2a: bool = True):
    get_arch, reduce_config = pkg
    arch, aux, drop = case.split("-")
    return reduce_config(get_arch(ARCH[arch])[0]).replace(
        moe_aux_free=aux == "auxfree", moe_capacity_factor=CF[drop], moe_a2a=a2a)


def _inputs() -> dict:
    """Per arch: MoE params and two batches (B divisible by the data axis, and 3, not)."""
    from repro_torch.configs import get_arch, reduce_config

    rng = np.random.default_rng(0)
    out = {}
    for arch in ARCH:
        cfg = _cfg((get_arch, reduce_config), f"{arch}-auxfree-drops")
        d, e, f = cfg.d_model, cfg.n_routed_experts, cfg.moe_d_ff
        fs = f * cfg.n_shared_experts
        p = {
            "router": rng.standard_normal((d, e)) / np.sqrt(d),
            "bias": rng.standard_normal(e) * 0.3,
            "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
            "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
            "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f),
            "shared_gate": rng.standard_normal((d, fs)) / np.sqrt(d),
            "shared_up": rng.standard_normal((d, fs)) / np.sqrt(d),
            "shared_down": rng.standard_normal((fs, d)) / np.sqrt(fs),
            "x": rng.standard_normal((B, S, d)),
            "x3": rng.standard_normal((3, S, d)),
        }
        out.update({f"{arch}.{k}": v.astype(np.float32) for k, v in p.items()})
    cot = np.random.default_rng(1)  # the cotangents the gradients are taken along
    for arch in ARCH:
        out[f"{arch}.cot"] = cot.standard_normal(out[f"{arch}.x"].shape).astype(np.float32)
    return out


def _params(d: dict, arch: str, lib) -> dict:
    return {k.split(".", 1)[1]: lib(v) for k, v in d.items()
            if k.startswith(arch + ".") and not k.endswith((".x", ".x3", ".cot"))}


GRADS = ("x", "router", "w_gate", "w_up", "w_down")


# ------------------------------------------------------------ the world
def _world(rank: int, world: int, inputs: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from repro_torch.common.sharding import concrete_mesh, mesh_context
    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.models import moe
    from repro_torch.models.moe_a2a import moe_a2a_applicable, moe_ffn_a2a

    d = dict(np.load(inputs))
    mesh = concrete_mesh((2, 2), ("data", "model"), device_type="cpu")
    res = {}
    for case in CASES:
        arch = case.split("-")[0]
        try:
            cfg = _cfg((get_arch, reduce_config), case)
            params = _params(d, arch, torch.from_numpy)
            x = torch.from_numpy(d[f"{arch}.x"])
            with mesh_context(mesh):
                res[case] = {
                    "a2a": moe_ffn_a2a(params, cfg, x).numpy(),
                    "dispatch": moe.moe_dispatch(params, cfg, x).numpy(),
                    "dispatch_b3": moe.moe_dispatch(params, cfg,
                                                    torch.from_numpy(d[f"{arch}.x3"])).numpy(),
                    "dispatch_off": moe.moe_dispatch(params, cfg.replace(moe_a2a=False),
                                                     x).numpy(),
                    "applicable": np.array([moe_a2a_applicable(cfg)]),
                }
            # gradients of sum(y * cot) through the all-to-alls and the psum
            leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
            xg = x.clone().requires_grad_()
            with mesh_context(mesh):
                y = moe_ffn_a2a(leaves, cfg, xg)
            (y * torch.from_numpy(d[f"{arch}.cot"])).sum().backward()
            res[case].update({f"grad_{k}": (xg if k == "x" else leaves[k]).grad.numpy()
                              for k in GRADS})
        except Exception:
            res[case] = traceback.format_exc()
    if rank == 0:
        torch.save(res, os.path.join(out_dir, "world.pt"))


# ------------------------------------------------------------ the reference
REF = r"""
import itertools, sys, numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, sys.argv[2])
from test_torch_moe_a2a import CASES, DISPATCH, GRADS, _cfg, _params
from repro.common.sharding import mesh_context
from repro.configs import get_arch, reduce_config
from repro.models.moe import moe_dispatch, moe_ffn
from repro.models.moe_a2a import moe_ffn_a2a
d = dict(np.load(sys.argv[1] + "/inputs.npz"))
mesh = jax.make_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4],
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
for case in CASES:
    arch = case.split("-")[0]
    cfg = _cfg((get_arch, reduce_config), case)
    p = _params(d, arch, jnp.asarray)
    x, x3 = jnp.asarray(d[arch + ".x"]), jnp.asarray(d[arch + ".x3"])
    with mesh_context(mesh):
        out[case + ".a2a"] = jax.jit(lambda p, x: moe_ffn_a2a(p, cfg, x))(p, x)
        cot = jnp.asarray(d[arch + ".cot"])
        gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(moe_ffn_a2a(p, cfg, x) * cot),
                                  argnums=(0, 1)))(p, x)
        for k in GRADS:
            out[case + ".grad_" + k] = gx if k == "x" else gp[k]
        if case in DISPATCH:
            out[case + ".dispatch"] = jax.jit(lambda p, x: moe_dispatch(p, cfg, x))(p, x)
            out[case + ".dispatch_b3"] = jax.jit(lambda p, x: moe_dispatch(p, cfg, x))(p, x3)
    if case.endswith("dropless"):
        out[case + ".ffn"] = jax.jit(lambda p, x: moe_ffn(p, cfg, x))(p, x)
np.savez(sys.argv[1] + "/ref.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.distributed.comm import run_world

    d = tmp_path_factory.mktemp("torch_moe_a2a")
    np.savez(d / "inputs.npz", **_inputs())
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    ref = subprocess.Popen([sys.executable, "-c", REF, str(d), os.path.dirname(__file__)],
                           env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        run_world(_world, 4, str(d / "inputs.npz"), str(d), backend="gloo", timeout_s=300.0)
    finally:
        out, err = ref.communicate(timeout=420)
    assert ref.returncode == 0, f"reference:\n{out}\n{err}"
    return torch.load(d / "world.pt", weights_only=False), dict(np.load(d / "ref.npz")), \
        dict(np.load(d / "inputs.npz"))


def _got(runs, case):
    res = runs[0][case]
    if isinstance(res, str):
        pytest.fail(f"case {case} raised in the world:\n{res}")
    return res


def _plain(runs, case):
    """``moe_a2a_ref`` in this one process, the shared experts' part, and
    the share of dropped slots (the plain version's own count, which
    ``route_slots`` must repeat)."""
    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.models import moe
    from repro_torch.models.moe_a2a import moe_a2a_ref, route_slots

    cfg = _cfg((get_arch, reduce_config), case)
    arch = case.split("-")[0]
    p = _params(runs[2], arch, torch.from_numpy)
    x = torch.from_numpy(runs[2][f"{arch}.x"])
    experts = lambda e: (p["w_gate"][e], p["w_up"][e], p["w_down"][e])  # noqa: E731
    y, dropped = moe_a2a_ref(x, p["router"], p["bias"], experts, cfg, 2, 2)
    shared = moe._shared(p, x)
    sources = x.reshape(2, -1, 2, x.shape[-1])
    by_route = [route_slots(sources[i, :, j], p["router"], p["bias"], cfg, 4)[5]
                for i in range(2) for j in range(2)]
    assert float(torch.cat(by_route).float().mean()) == dropped
    return y.numpy(), shared.numpy(), dropped


@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_a2a_equals_reference(runs, case):
    got = _got(runs, case)
    np.testing.assert_allclose(got["a2a"], runs[1][f"{case}.a2a"], atol=ATOL, rtol=RTOL)
    assert got["applicable"].all()


@pytest.mark.parametrize("case", CASES)
def test_moe_ffn_a2a_gradients_equal_reference(runs, case):
    """Gradients of sum(y * cot) in the tokens, the router and the routed
    experts, through the three all-to-alls out, the one back and the psum
    over model, against ``jax.grad`` of the reference's: each within 1e-4
    relative plus 1e-5 of its largest element (fp32, sums in other orders)."""
    got = _got(runs, case)
    for k in GRADS:
        want = runs[1][f"{case}.grad_{k}"]
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(got[f"grad_{k}"], want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_moe_a2a_ref_equals_reference_and_world(runs, case):
    y, shared, dropped = _plain(runs, case)
    np.testing.assert_allclose(y, runs[1][f"{case}.a2a"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(y, _got(runs, case)["a2a"], atol=ATOL, rtol=RTOL)
    if case.endswith("dropless"):
        assert dropped == 0.0
        # nothing dropped: the grouped path (shared experts included) agrees
        np.testing.assert_allclose(y + shared, runs[1][f"{case}.ffn"], atol=ATOL, rtol=RTOL)
    else:
        assert 0.0 < dropped < 1.0, dropped


@pytest.mark.parametrize("case", DISPATCH)
def test_moe_dispatch_takes_a2a_where_it_applies(runs, case):
    """On the (2, 2) mesh: the all-to-all plus the shared experts where the
    batch splits over data (B = 4), the grouped path where it does not
    (B = 3) or where ``moe_a2a`` is off; each as the reference's."""
    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.models import moe

    got = _got(runs, case)
    np.testing.assert_allclose(got["dispatch"], runs[1][f"{case}.dispatch"], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got["dispatch_b3"], runs[1][f"{case}.dispatch_b3"],
                               atol=ATOL, rtol=RTOL)
    cfg = _cfg((get_arch, reduce_config), case)
    arch = case.split("-")[0]
    p = _params(runs[2], arch, torch.from_numpy)
    x3 = torch.from_numpy(runs[2][f"{arch}.x3"])
    x = torch.from_numpy(runs[2][f"{arch}.x"])
    np.testing.assert_array_equal(got["dispatch_b3"], moe.moe_ffn(p, cfg, x3).numpy())
    np.testing.assert_array_equal(got["dispatch_off"], moe.moe_ffn(p, cfg, x).numpy())
    shared = moe._shared(p, x).numpy()
    np.testing.assert_allclose(got["dispatch"], got["a2a"] + shared, atol=ATOL, rtol=RTOL)


def test_moe_dispatch_outside_a_mesh_is_the_grouped_path(runs):
    from repro_torch.configs import get_arch, reduce_config
    from repro_torch.models import moe
    from repro_torch.models.moe_a2a import moe_a2a_applicable

    cfg = _cfg((get_arch, reduce_config), CASES[0])
    p = _params(runs[2], "v3", torch.from_numpy)
    x = torch.from_numpy(runs[2]["v3.x"])
    assert not moe_a2a_applicable(cfg)
    assert torch.equal(moe.moe_dispatch(p, cfg, x), moe.moe_ffn(p, cfg, x))
