"""granite-moe-3b-a800m [moe] — 32L d1536 24H (GQA kv=8) d_ff=512/expert,
vocab 49155, MoE 40 experts top-8 [assignment; hf:ibm-granite family]."""

from .base import LMConfig, Segment

CONFIG = LMConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab=49155,
    segments=(Segment("attn", 32),),
    n_experts=40,
    top_k=8,
    act="silu",
    microbatch=16,
)
