"""Architecture config system (counterpart of ``repro.configs.base``).

``LMConfig`` fully describes one assigned architecture: geometry, layer
segments (scan groups), attention pattern, MoE/SSM/recurrent settings,
modality frontend stubs, and the parallelism plan.  Each
``repro_torch/configs/<arch>.py`` exports ``CONFIG`` built from the
assignment's exact numbers plus ``CONFIG.smoke()`` for CPU tests.

Layer *segments*: a model is an ordered list of segments; each segment
holds stacked layer parameters with a leading layer axis, which the port
walks with a Python loop (the reference scans them with ``lax.scan``).  A
segment's per-layer attention window pattern cycles over its layers, so
mixed local/global stacks (gemma2/gemma3) share one block.
Hybrid models (recurrentgemma) use a super-block segment whose body holds
multiple sub-blocks of different types.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

GLOBAL_WINDOW = 1 << 30     # "window" value meaning full/global attention


@dataclass(frozen=True)
class Segment:
    """One scanned group of layers.

    kind: 'attn' (attention+FFN; FFN is MoE when cfg.n_experts>0),
          'ssm' (mamba block), 'rec' (RG-LRU block + FFN),
          'hybrid3' (super-block: rec, rec, attn-local — recurrentgemma),
          'xattn' (decoder layer with self+cross attention — whisper dec).
    n: number of layers (super-blocks for 'hybrid3') in the scan.
    window_pattern: per-layer sliding windows, cycled to length n
        (GLOBAL_WINDOW = full attention).  Only used by attention kinds.
    """

    kind: str
    n: int
    window_pattern: Tuple[int, ...] = (GLOBAL_WINDOW,)

    def windows(self) -> Tuple[int, ...]:
        p = self.window_pattern
        return tuple(p[i % len(p)] for i in range(self.n))


@dataclass(frozen=True)
class LMConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    segments: Tuple[Segment, ...]
    head_dim: Optional[int] = None    # default d_model // n_heads
    # attention extras
    attn_softcap: Optional[float] = None
    logit_softcap: Optional[float] = None
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"           # rope | learned
    # ffn
    mlp_kind: str = "gated"           # gated | plain
    act: str = "silu"
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm / recurrent
    ssm_state: int = 0
    d_inner: int = 0                  # ssm/rglru inner width
    dt_rank: int = 0
    conv_k: int = 4
    # enc-dec (whisper): encoder stack config
    enc_segments: Tuple[Segment, ...] = ()
    enc_frame_dim: int = 0            # stub frontend: precomputed frame embs
    dec_len_ratio: int = 8            # dec_len = seq_len // ratio
    # vlm (paligemma): stub image prefix
    num_prefix_tokens: int = 0
    prefix_dim: int = 0
    norm_kind: str = "rms"            # rms | ln
    # training plan
    fsdp: bool = False                # shard params/opt-state over data too
    microbatch: int = 32              # per-gradient-accumulation-step batch
    remat: bool = True
    scan_unroll: bool = False     # full-unroll scans (exact dry-run cost)
    chunk_scan: bool = True       # lax.scan q-chunks (False: python loop, exact cost)
    tie_embeddings: bool = True
    # which shapes this arch supports (skips documented in DESIGN.md)
    supports_long: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return sum(s.n * (3 if s.kind == "hybrid3" else 1)
                   for s in self.segments)

    def is_encdec(self) -> bool:
        return bool(self.enc_segments)

    # -- reduced variant for CPU smoke tests -------------------------------
    def smoke(self) -> "LMConfig":
        def shrink_seg(s: Segment) -> Segment:
            return replace(s, n=min(s.n, 2),
                           window_pattern=tuple(min(w, 64) if w < GLOBAL_WINDOW
                                                else w
                                                for w in s.window_pattern))

        return replace(
            self,
            name=self.name + "-smoke",
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab=256,
            segments=tuple(shrink_seg(s) for s in self.segments),
            enc_segments=tuple(shrink_seg(s) for s in self.enc_segments),
            n_experts=min(self.n_experts, 8) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_inner=128 if self.d_inner else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            dt_rank=8 if self.dt_rank else 0,
            enc_frame_dim=64 if self.enc_frame_dim else 0,
            num_prefix_tokens=min(self.num_prefix_tokens, 8),
            prefix_dim=64 if self.prefix_dim else 0,
            microbatch=4,
        )


# ---------------------------------------------------------------------------
# input shapes (the assignment's four shapes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str            # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}



def shape_supported(cfg: LMConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(supported, reason-if-not) — the documented skip rules."""
    if shape.name == "long_500k" and not cfg.supports_long:
        return False, ("pure full-attention arch: 500k decode KV is "
                       "quadratic-history; skipped per assignment")
    return True, ""
