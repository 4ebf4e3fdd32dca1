"""deepseek-v3-671b [arXiv:2412.19437; hf]: 61L d7168 128H MLA
(q_lora 1536, kv_lora 512, rope 64, nope 128, v 128), MoE 256 routed top-8
+ 1 shared, moe_ff 2048, dense ff 18432, first 3 layers dense,
aux-loss-free bias routing, MTP head, vocab 129280."""
from repro_torch.common.config import ArchConfig
from repro_torch.configs.shapes import LM_SHAPES

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="lm",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    use_moe=True,
    n_routed_experts=256,
    n_shared_experts=1,
    top_k=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    moe_aux_free=True,
    use_mtp=True,
    moe_a2a=True,  # explicit token all-to-all dispatch on a mesh
)
SHAPES = LM_SHAPES
SKIP_SHAPES = {}
