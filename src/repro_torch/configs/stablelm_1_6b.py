"""stablelm-1.6b [dense] — 24L d2048 32H (MHA kv=32) d_ff=5632,
vocab 100352 [assignment; hf:stabilityai/stablelm-2-1_6b]."""

from .base import LMConfig, Segment

CONFIG = LMConfig(
    name="stablelm-1.6b",
    family="dense",
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab=100352,
    segments=(Segment("attn", 24),),
    act="silu",
    microbatch=64,
)
