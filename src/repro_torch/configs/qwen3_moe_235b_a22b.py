"""qwen3-moe-235b-a22b [moe] — 94L d4096 64H (GQA kv=4) d_ff=1536/expert,
vocab 151936, MoE 128 experts top-8 [assignment; hf:Qwen/Qwen3 family].

head_dim follows d_model//n_heads = 64 (assignment geometry; the hf
Qwen3 uses an explicit 128 — noted in DESIGN.md)."""

from .base import LMConfig, Segment

CONFIG = LMConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    segments=(Segment("attn", 94),),
    n_experts=128,
    top_k=8,
    act="silu",
    fsdp=True,
    microbatch=16,
)
