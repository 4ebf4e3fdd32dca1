"""RecSys family: DLRM (MLPerf), FM, BST, MIND.

Shared substrate:
  * EmbeddingBag — a gather and a sum (the reference's ``jnp.take`` +
    segment_sum). Tables are row-sharded over the `model` axis
    ("table_vocab" logical axis).
  * retrieval scoring — one user context against n_candidates items, batched
    (never a loop): models with a factorized target term (FM, BST, MIND) use
    their closed form; DLRM broadcasts the shared user-side computation.

Every lookup clamps its ids to [0, V-1], as the reference's
``jnp.take(..., mode="clip")`` does: torch indexing would wrap -1 to the
last row and fail on an id >= V.  Tables are drawn on the model's device
from its generator (FM's 187.8M rows never exist on the host).

Batch layouts:
  dlrm: dense (B,13) f32, sparse (B,26) i32, label (B,)
  fm:   sparse (B,39) i32, label (B,)
  bst:  hist (B,L) i32, target (B,) i32, label (B,)
  mind: hist (B,L) i32, target (B,) i32, label (B,)
"""
from __future__ import annotations

import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from repro_torch.common import nn
from repro_torch.common.config import ArchConfig
from repro_torch.common.device import init_generator, resolve_device
from repro_torch.common.sharding import constrain, is_dtensor, local_blocks, local_rows, take_rows

# MLPerf DLRM Criteo-1TB per-field vocabulary sizes (26 categorical fields)
CRITEO_VOCABS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` clamped to [0, V-1]: ``jnp.take(table,
    ids, axis=0, mode="clip")``.  A DTensor table is read in place
    (``sharding.take_rows``)."""
    ids = ids.long().clamp(0, table.shape[0] - 1)
    return take_rows(table, ids) if is_dtensor(table) else table[ids]


# ------------------------------------------------------------ EmbeddingBag
def embedding_bag(
    table: torch.Tensor,  # (V, D)
    indices: torch.Tensor,  # (B, L) int32, -1 = pad
    *,
    mode: str = "sum",
) -> torch.Tensor:
    """Multi-hot lookup-reduce: (B, L) ids -> (B, D)."""
    mask = (indices >= 0).to(table.dtype)[..., None]
    rows = take(table, torch.clamp(indices, min=0)) * mask
    out = rows.sum(dim=1)
    if mode == "mean":
        out = out / torch.clamp(mask.sum(dim=1), min=1.0)
    return out


def init_tables(gen, vocab_sizes, dim, dtype=torch.float32, scale=0.01, *, device=None):
    tables = [nn.normal_init(gen, (v, dim), scale, dtype=dtype, device=device)
              for v in vocab_sizes]
    return tables, [("table_vocab", None) for _ in vocab_sizes]


def _model(tree: dict, axes: dict) -> tuple[nn.ParamTree, dict[str, tuple]]:
    return nn.ParamTree(tree), nn.flat_axes(axes)


# ------------------------------------------------------------------ DLRM
def init_dlrm(seed, cfg: ArchConfig, dtype=torch.float32, *, device="cuda"):
    gen, dev = init_generator(seed, device)
    kw = dict(dtype=dtype, device=dev)
    params: dict[str, Any] = {}
    axes: dict[str, Any] = {}
    params["tables"], axes["tables"] = init_tables(gen, cfg.vocab_sizes, cfg.embed_dim, **kw)
    params["bot"] = nn.mlp_init(gen, [cfg.n_dense, *cfg.bot_mlp], **kw)
    axes["bot"] = nn.mlp_axes(len(cfg.bot_mlp))
    n_f = cfg.n_sparse + 1
    n_int = n_f * (n_f - 1) // 2
    top_in = n_int + cfg.bot_mlp[-1]
    params["top"] = nn.mlp_init(gen, [top_in, *cfg.top_mlp], **kw)
    axes["top"] = nn.mlp_axes(len(cfg.top_mlp))
    return _model(params, axes)


def _dlrm_interact(emb: torch.Tensor) -> torch.Tensor:
    """emb (B, F, D) -> upper-triangle of emb @ embᵀ, (B, F(F-1)/2); on a
    mesh, on each rank's rows, split over ``model`` too where it divides
    them and does not split them yet (the output then laid out so: the
    caller gathers it), so that the ranks of a model row share the product,
    as the reference's plan shares it."""
    if is_dtensor(emb):
        mesh = emb.device_mesh
        names = list(mesh.mesh_dim_names)
        rows = {a for a, p in zip(names, emb.placements) if p.is_shard(0)}
        if "model" in names and "model" not in rows and emb.shape[0] % math.prod(
                mesh.size(names.index(a)) for a in rows | {"model"}) == 0:
            rows.add("model")
        spec = (tuple(a for a in names if a in rows) or None,)
        return local_blocks(_dlrm_interact, [(emb, spec)], spec)
    f = emb.shape[1]
    z = torch.bmm(emb, emb.transpose(1, 2))
    iu, ju = torch.triu_indices(f, f, offset=1, device=emb.device)
    return z[:, iu, ju]


def _dlrm_bottom(params, dense: torch.Tensor) -> torch.Tensor:
    """The bottom MLP, (B, 13) -> (B, D).  On a mesh its three layers run
    tensor-parallel over ``model``, so the last one's output is split over
    it: the interaction needs every unit, so this narrow output is gathered
    here, the one gather of the MLPs."""
    return constrain(nn.mlp(params["bot"], dense, act=F.relu, final_act=F.relu), "batch", None)


def dlrm_forward(params, cfg: ArchConfig, batch) -> torch.Tensor:
    x = _dlrm_bottom(params, batch["dense"])
    embs = [take(t, batch["sparse"][:, i]) for i, t in enumerate(params["tables"])]
    emb = torch.stack([x, *embs], dim=1)  # (B, 27, D)
    inter = constrain(_dlrm_interact(emb), "batch", None)
    top_in = torch.cat([x, inter], dim=-1)
    return nn.mlp(params["top"], top_in, act=F.relu)[..., 0]


def dlrm_retrieval(params, cfg: ArchConfig, batch, candidates: torch.Tensor) -> torch.Tensor:
    """Score 1 user context x C candidate items in sparse field 0."""
    x = _dlrm_bottom(params, batch["dense"])  # (1, D)
    fixed = [take(t, batch["sparse"][:, i]) for i, t in enumerate(params["tables"]) if i != 0]
    c = candidates.shape[0]
    cand_emb = take(params["tables"][0], candidates)  # (C, D)
    user = torch.stack([x[0], *[f[0] for f in fixed]], dim=0)  # (F, D)
    # broadcast: emb (C, F+1, D) with candidate in slot 1
    emb = torch.cat(
        [
            user[None, :1].expand(c, 1, user.shape[1]),
            cand_emb[:, None],
            user[None, 1:].expand(c, user.shape[0] - 1, user.shape[1]),
        ],
        dim=1,
    )
    inter = _dlrm_interact(emb)
    top_in = torch.cat([x.expand(c, x.shape[1]), inter], dim=-1)
    return nn.mlp(params["top"], top_in, act=F.relu)[..., 0]


# ------------------------------------------------------------------ FM
def init_fm(seed, cfg: ArchConfig, dtype=torch.float32, *, device="cuda"):
    gen, dev = init_generator(seed, device)
    kw = dict(dtype=dtype, device=dev)
    params: dict[str, Any] = {"w0": torch.zeros((), **kw)}
    axes: dict[str, Any] = {"w0": ()}
    params["tables"], axes["tables"] = init_tables(gen, cfg.vocab_sizes, cfg.embed_dim, **kw)
    params["linear"], axes["linear"] = init_tables(gen, cfg.vocab_sizes, 1, **kw)
    return _model(params, axes)


def _fm_fields(tables, sparse: torch.Tensor) -> torch.Tensor:
    return torch.stack([take(t, sparse[:, i]) for i, t in enumerate(tables)], dim=1)


def fm_forward(params, cfg: ArchConfig, batch) -> torch.Tensor:
    """Rendle's O(nk) sum-square trick: ½[(Σv)² − Σv²]."""
    vs = _fm_fields(params["tables"], batch["sparse"])  # (B, F, K)
    lin = _fm_fields(params["linear"], batch["sparse"]).sum(dim=(1, 2))
    s = vs.sum(dim=1)
    pair = 0.5 * (s.square() - vs.square().sum(dim=1)).sum(dim=-1)
    return params["w0"] + lin + pair


def fm_retrieval(params, cfg: ArchConfig, batch, candidates: torch.Tensor) -> torch.Tensor:
    """Factorized: score(c) = base + lin_c + v_c·S, S = Σ_{f≠0} v_f."""
    vs = _fm_fields(params["tables"], batch["sparse"])[0]  # (F, K) single user
    lin_fixed = _fm_fields(params["linear"], batch["sparse"])[0, 1:].sum()
    s_fixed = vs[1:].sum(dim=0)  # (K,)
    pair_fixed = 0.5 * (s_fixed.square() - vs[1:].square().sum(dim=0)).sum()
    v_c = take(params["tables"][0], candidates)  # (C, K)
    lin_c = take(params["linear"][0], candidates)[:, 0]
    return params["w0"] + lin_fixed + pair_fixed + lin_c + v_c @ s_fixed


# ------------------------------------------------------------------ BST
def init_bst(seed, cfg: ArchConfig, dtype=torch.float32, *, device="cuda"):
    gen, dev = init_generator(seed, device)
    kw = dict(dtype=dtype, device=dev)
    d, nh = cfg.embed_dim, cfg.n_heads
    seq = cfg.hist_len + 1
    params: dict[str, Any] = {
        "item_table": nn.normal_init(gen, (cfg.vocab_sizes[0], d), 0.01, **kw),
        "pos_table": nn.normal_init(gen, (seq, d), 0.01, **kw),
    }
    axes: dict[str, Any] = {"item_table": ("table_vocab", None), "pos_table": (None, None)}
    s = 1.0 / math.sqrt(d)
    params["attn"] = {
        "wq": nn.normal_init(gen, (d, nh, d // nh), s, **kw),
        "wk": nn.normal_init(gen, (d, nh, d // nh), s, **kw),
        "wv": nn.normal_init(gen, (d, nh, d // nh), s, **kw),
        "wo": nn.normal_init(gen, (nh, d // nh, d), s, **kw),
    }
    axes["attn"] = {
        "wq": (None, "heads", None),
        "wk": (None, "heads", None),
        "wv": (None, "heads", None),
        "wo": ("heads", None, None),
    }
    params["ffn"] = nn.mlp_init(gen, [d, 4 * d, d], **kw)
    axes["ffn"] = nn.mlp_axes(2)
    params["ln1"] = nn.layernorm_init(d, **kw)
    params["ln2"] = nn.layernorm_init(d, **kw)
    axes["ln1"] = axes["ln2"] = nn.LAYERNORM_AXES
    params["mlp"] = nn.mlp_init(gen, [seq * d, *cfg.top_mlp, 1], **kw)
    axes["mlp"] = nn.mlp_axes(len(cfg.top_mlp) + 1)
    return _model(params, axes)


def _bst_attention(cfg: ArchConfig, h: torch.Tensor, wq, wk, wv, wo) -> torch.Tensor:
    """One self-attention block on h (B, L+1, D) -> (B, L+1, D)."""
    q = torch.einsum("bsd,dhk->bshk", h, wq)
    k = torch.einsum("bsd,dhk->bshk", h, wk)
    v = torch.einsum("bsd,dhk->bshk", h, wv)
    scale = math.sqrt(cfg.embed_dim // cfg.n_heads)
    p = torch.softmax(torch.einsum("bshk,bthk->bhst", q, k) / scale, dim=-1)
    o = torch.einsum("bhst,bthk->bshk", p, v)
    del p  # (B, H, S, S): over 1M retrieval candidates the largest tensor, 14 GB
    return torch.einsum("bshk,hkd->bsd", o, wo)


def _bst_encode(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, L+1, D), the items' rows plus their positions -> transformer
    output (B, (L+1)·D); on a mesh, on each rank's rows."""
    attn = params["attn"]
    h = nn.layernorm(params["ln1"], x)
    x = x + local_rows(lambda hb, *w: _bst_attention(cfg, hb, *w), (h,),
                       (attn["wq"], attn["wk"], attn["wv"], attn["wo"]))
    h = nn.layernorm(params["ln2"], x)
    x = x + nn.mlp(params["ffn"], h, act=F.leaky_relu)
    return x.reshape(x.shape[0], -1)


def _bst_head(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    return nn.mlp(params["mlp"], _bst_encode(params, cfg, x), act=F.leaky_relu)[..., 0]


def bst_forward(params, cfg: ArchConfig, batch) -> torch.Tensor:
    items = torch.cat([batch["hist"], batch["target"][:, None]], dim=1)
    return _bst_head(params, cfg, take(params["item_table"], items) + params["pos_table"][None])


def _bst_items(cand: torch.Tensor, hist: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """cand (C, D), hist (L, D), pos (L+1, D) -> (C, L+1, D): the one
    history before each candidate, plus the positions."""
    items = torch.cat([hist[None].expand(cand.shape[0], *hist.shape), cand[:, None]], dim=1)
    return items + pos[None]


def bst_retrieval(params, cfg: ArchConfig, batch, candidates: torch.Tensor) -> torch.Tensor:
    """1 user history x C candidates: target slot varies over candidates.
    On a mesh each rank encodes its own candidates (split as they are),
    the one history whole."""
    if not is_dtensor(candidates):
        c = candidates.shape[0]
        hist = batch["hist"][:1].expand(c, batch["hist"].shape[1])
        return bst_forward(params, cfg, {"hist": hist, "target": candidates})
    table = params["item_table"]
    x = local_rows(_bst_items, (take(table, candidates),),
                   (take(table, batch["hist"][:1])[0], params["pos_table"]))
    return _bst_head(params, cfg, x)


# ------------------------------------------------------------------ MIND
def init_mind(seed, cfg: ArchConfig, dtype=torch.float32, *, device="cuda"):
    gen, dev = init_generator(seed, device)
    kw = dict(dtype=dtype, device=dev)
    d = cfg.embed_dim
    params = {
        "item_table": nn.normal_init(gen, (cfg.vocab_sizes[0], d), 0.01, **kw),
        # shared bilinear map S (capsule routing, B2I variant)
        "s_map": nn.normal_init(gen, (d, d), 1.0 / math.sqrt(d), **kw),
        # fixed (non-trainable in paper; trainable here) routing init logits
        "b_init": nn.normal_init(gen, (cfg.n_interests, cfg.hist_len), 0.1, **kw),
    }
    axes = {"item_table": ("table_vocab", None), "s_map": (None, None), "b_init": (None, None)}
    return _model(params, axes)


def _squash(x: torch.Tensor) -> torch.Tensor:
    n2 = x.square().sum(dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)


def _mind_routing(cfg: ArchConfig, eh: torch.Tensor, hist: torch.Tensor,
                  b_init: torch.Tensor) -> torch.Tensor:
    """The routing of (B, L, D) mapped behaviour rows eh of (B, L) ids -> (B, J, D)."""
    mask = (hist >= 0).to(eh.dtype)
    b_log = b_init[None].expand(eh.shape[0], *b_init.shape)
    u = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b_log, dim=1)  # over interests
        w = w * mask[:, None, :]
        z = torch.einsum("bjl,bld->bjd", w, eh)
        u = _squash(z)
        b_log = b_log + torch.einsum("bjd,bld->bjl", u, eh)
    return u


def mind_interests(params, cfg: ArchConfig, hist: torch.Tensor) -> torch.Tensor:
    """Behavior→Interest dynamic routing: (B, L) ids -> (B, J, D) capsules;
    on a mesh, on each rank's rows."""
    eh = take(params["item_table"], hist) @ params["s_map"]  # (B, L, D)
    return local_rows(lambda ehb, hb, b_init: _mind_routing(cfg, ehb, hb, b_init),
                      (eh, hist), (params["b_init"],))


def _mind_target_scores(u: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """u (B, J, D), t (B, D) -> max_j u_j · t, (B,)."""
    return torch.einsum("bjd,bd->bj", u, t).amax(dim=-1)


def mind_forward(params, cfg: ArchConfig, batch) -> torch.Tensor:
    """Label-aware: score = max_j u_j · target (serving form, MIND §4)."""
    u = mind_interests(params, cfg, batch["hist"])  # (B, J, D)
    t = take(params["item_table"], batch["target"])  # (B, D)
    return local_rows(_mind_target_scores, (u, t))


def _mind_scores(cand: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """cand (C, D), u (J, D) -> max_j u_j · cand, (C,)."""
    return torch.einsum("jd,cd->cj", u, cand).amax(dim=-1)


def mind_retrieval(params, cfg: ArchConfig, batch, candidates: torch.Tensor) -> torch.Tensor:
    """On a mesh each rank scores its own candidates (split as they are)."""
    u = mind_interests(params, cfg, batch["hist"][:1])  # (1, J, D)
    cand = take(params["item_table"], candidates)  # (C, D), laid out as the candidates
    return local_rows(_mind_scores, (cand,), (u[0],))


# ------------------------------------------------------------------ losses
def _bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return -(labels * F.logsigmoid(logits) + (1 - labels) * F.logsigmoid(-logits))


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean(local_rows(_bce, (logits, labels)))


FORWARD = {"dlrm-mlperf": dlrm_forward, "fm": fm_forward, "bst": bst_forward, "mind": mind_forward}
RETRIEVAL = {
    "dlrm-mlperf": dlrm_retrieval,
    "fm": fm_retrieval,
    "bst": bst_retrieval,
    "mind": mind_retrieval,
}
INIT = {"dlrm-mlperf": init_dlrm, "fm": init_fm, "bst": init_bst, "mind": init_mind}


def recsys_loss(params, cfg: ArchConfig, batch) -> torch.Tensor:
    return bce_loss(FORWARD[cfg.name](params, cfg, batch), batch["label"])


def recsys_params_from_jax(params_np: Mapping[str, Any], cfg: ArchConfig, *,
                           device: str | torch.device = "cuda") -> nn.ParamTree:
    """The reference's params for ``cfg`` (arrays as numpy, or anything
    ``np.asarray`` reads) as the port's model, leaf for leaf: tables stay
    lists, BST's attention weights keep their (d, H, d/H) and (H, d/H, d)
    layouts, FM's ``w0`` stays 0-d."""
    if cfg.name not in INIT:
        raise ValueError(f"{cfg.name} is not a recsys arch")
    return nn.ParamTree(nn.tree_to_torch(params_np, resolve_device(device)))
