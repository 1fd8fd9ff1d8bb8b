"""gemma3-1b [dense] — 26L d1152 4H (MQA kv=1) d_ff=6912, vocab 262144,
5 local (512-window) : 1 global pattern, 128k-class context
[assignment; hf:google/gemma-3-1b-pt]."""

from .base import GLOBAL_WINDOW, LMConfig, Segment

CONFIG = LMConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    segments=(Segment("attn", 26,
                      window_pattern=(512, 512, 512, 512, 512,
                                      GLOBAL_WINDOW)),),
    act="gelu",
    rope_theta=1_000_000.0,
    supports_long=True,        # 5/6 of layers are 512-window local
    microbatch=64,
)
