"""whisper-small [audio] — 12L encoder + 12L decoder, d768 12H (MHA)
d_ff=3072, vocab 51865; conv frontend STUBBED: input_specs provides
precomputed frame embeddings (B, frames, 768); sinusoidal positions
[assignment; arXiv:2212.04356]."""

from .base import LMConfig, Segment

CONFIG = LMConfig(
    name="whisper-small",
    family="audio",
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51865,
    segments=(Segment("xattn", 12),),          # decoder
    enc_segments=(Segment("attn", 12),),       # encoder (non-causal)
    enc_frame_dim=768,
    dec_len_ratio=8,
    mlp_kind="plain",
    act="gelu",
    pos_embed="sinusoid",
    norm_kind="ln",
    microbatch=64,
)
