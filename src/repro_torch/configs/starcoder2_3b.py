"""starcoder2-3b [dense] — 30L d3072 24H (GQA kv=2) d_ff=12288,
vocab 49152, GQA + RoPE, plain GeLU MLP [assignment; arXiv:2402.19173]."""

from .base import LMConfig, Segment

CONFIG = LMConfig(
    name="starcoder2-3b",
    family="dense",
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12288,
    vocab=49152,
    segments=(Segment("attn", 30),),
    mlp_kind="plain",
    act="gelu",
    microbatch=16,
)
