"""Config registry: --arch <id> resolution for launchers and tests."""
from __future__ import annotations

import dataclasses
from importlib import import_module

from repro_torch.common.config import ArchConfig, ShapeSpec

_MODULES = {
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "gemma-2b": "repro_torch.configs.gemma_2b",
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "bst": "repro_torch.configs.bst",
    "fm": "repro_torch.configs.fm",
    "dlrm-mlperf": "repro_torch.configs.dlrm_mlperf",
    "mind": "repro_torch.configs.mind",
    "learned-index": "repro_torch.configs.learned_index",
}

ARCH_IDS = tuple(k for k in _MODULES if k != "learned-index")


def get_arch(name: str):
    """Returns (ArchConfig, shapes tuple, skip dict)."""
    mod = import_module(_MODULES[name])
    return mod.CONFIG, mod.SHAPES, mod.SKIP_SHAPES


def reduce_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw: dict = {}
    if cfg.family == "lm":
        kw = dict(
            n_layers=2 * len(cfg.attn_types) + (cfg.first_dense_layers if cfg.use_moe else 0),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(cfg.n_kv_heads, 2),
            head_dim=16,
            d_ff=128,
            vocab_size=251,
        )
        if cfg.use_mla:
            kw.update(
                n_kv_heads=4, kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16, q_lora_rank=24 if cfg.q_lora_rank else None,
            )
        if cfg.use_moe:
            # dropless at smoke scale: decode==full-forward must hold exactly
            kw.update(n_routed_experts=8, top_k=min(cfg.top_k, 2), moe_d_ff=32,
                      moe_capacity_factor=1e9)
    elif cfg.family == "gnn":
        kw = dict(gnn_layers=3, gnn_hidden=32, node_feat_dim=16, edge_feat_dim=4)
    elif cfg.family == "recsys":
        kw = dict(vocab_sizes=tuple(min(v, 1000) for v in cfg.vocab_sizes))
    return dataclasses.replace(cfg, **kw)
