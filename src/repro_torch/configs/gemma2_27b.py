"""gemma2-27b [dense] — 46L d4608 32H (GQA kv=16) d_ff=36864,
vocab 256000, local(4096)/global alternating, logit softcapping
[assignment; arXiv:2408.00118]."""

from .base import GLOBAL_WINDOW, LMConfig, Segment

CONFIG = LMConfig(
    name="gemma2-27b",
    family="dense",
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    segments=(Segment("attn", 46,
                      window_pattern=(4096, GLOBAL_WINDOW)),),
    attn_softcap=50.0,
    logit_softcap=30.0,
    act="gelu",
    supports_long=True,        # half the layers are 4096-window local
    fsdp=True,
    microbatch=32,
)
