"""deepseek-v2-lite-16b [arXiv:2405.04434; hf]: 27L d2048 16H MLA
(kv_lora=512, rope 64, nope 128, v 128), MoE 64 routed top-6 + 2 shared,
moe_ff 1408, dense ff 10944, first layer dense, vocab 102400."""
from repro_torch.common.config import ArchConfig
from repro_torch.configs.shapes import LM_SHAPES

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="lm",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    use_mla=True,
    q_lora_rank=None,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    use_moe=True,
    n_routed_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    moe_aux_free=False,  # v2 uses aux-loss balancing (softmax gate)
)
SHAPES = LM_SHAPES
# MLA = compressed-KV attention; 512k latent cache fits -> long_500k runs
SKIP_SHAPES = {}
