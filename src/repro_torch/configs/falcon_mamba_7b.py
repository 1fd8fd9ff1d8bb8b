"""falcon-mamba-7b [ssm] — 64L d4096, attn-free mamba1, ssm_state=16,
vocab 65024 [assignment; arXiv:2410.05355]."""

from .base import LMConfig, Segment

CONFIG = LMConfig(
    name="falcon-mamba-7b",
    family="ssm",
    d_model=4096,
    n_heads=1,          # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=65024,
    segments=(Segment("ssm", 64),),
    ssm_state=16,
    d_inner=8192,
    dt_rank=256,
    conv_k=4,
    supports_long=True,
    microbatch=16,
)
