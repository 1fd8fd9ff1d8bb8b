"""paligemma-3b [vlm] — 18L d2048 8H (MQA kv=1) d_ff=16384,
vocab 257216; SigLIP frontend STUBBED: input_specs provides 256
precomputed patch embeddings (B, 256, 2048) [assignment;
arXiv:2407.07726]."""

from .base import LMConfig, Segment

CONFIG = LMConfig(
    name="paligemma-3b",
    family="vlm",
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    segments=(Segment("attn", 18),),
    num_prefix_tokens=256,
    prefix_dim=2048,
    act="gelu",
    microbatch=32,
)
