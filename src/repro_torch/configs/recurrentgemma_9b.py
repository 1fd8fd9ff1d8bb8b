"""recurrentgemma-9b [hybrid] — 38L d4096 16H (MQA kv=1) d_ff=12288,
vocab 256000; RG-LRU + local attention at 2:1 (pattern rec,rec,attn):
12 super-blocks of 3 + 2 trailing recurrent layers = 38
[assignment; arXiv:2402.19427]."""

from .base import LMConfig, Segment

CONFIG = LMConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    segments=(Segment("hybrid3", 12, window_pattern=(2048,)),
              Segment("rec", 2)),
    d_inner=4096,
    conv_k=4,
    act="gelu",
    supports_long=True,
    microbatch=16,
)
