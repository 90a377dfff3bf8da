"""Architecture & run-shape configuration schema (a copy of
``repro.configs.base``: the port keeps its own, field for field).

One ``ArchConfig`` per assigned architecture lives in
``repro_torch/configs/<id>.py``; the shared input-shape set is defined here
(the assignment's train_4k / prefill_32k / decode_32k / long_500k cells).
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    shared_expert: bool = False
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int

    moe: MoEConfig | None = None

    # attention details
    qk_norm: bool = False
    nonparam_norm: bool = False     # OLMo: LayerNorm without scale/bias
    rope_theta: float = 10_000.0
    window: int = 0                 # local-attention window (0 = global)
    attn_chunk: int = 1024          # flash-style KV chunk for long sequences

    # block pattern: repeated unit; scan runs over pattern repetitions.
    #   'attn'  full-attention transformer block
    #   'moe'   MoE transformer block
    #   'rglru' RG-LRU recurrent block (Griffin)
    #   'lattn' local-attention block
    #   'mlstm' / 'slstm'  xLSTM blocks
    #   'xattn' cross-attention block (VLM)
    block_pattern: tuple[str, ...] = ("attn",)

    # encoder-decoder / multimodal frontends (stubs per assignment)
    encoder_layers: int = 0
    encoder_seq: int = 0            # whisper: 1500 precomputed frames
    vision_tokens: int = 0          # vision: precomputed patch embeddings

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moment_dtype: str = "float32"   # AdamW m/v (bf16 for 405B — DESIGN.md §5)
    remat: str = "dots"             # 'none' | 'dots' | 'full'

    # memory fitting (train_4k at 1M tokens/step)
    act_shard: str = "none"         # 'none' | 'seq' — shard the inter-layer
                                    # activation carry over 'model' (SP)
    grad_accum: int = 1             # microbatch accumulation factor

    # xLSTM / Griffin extras
    rnn_dim: int = 0                # RG-LRU recurrence width (0 → d_model)
    conv_width: int = 4

    sub_quadratic: bool = False     # supports long_500k decode

    @property
    def n_units(self) -> int:
        """Scanned repetitions of the block pattern."""
        return self.n_layers // len(self.block_pattern)

    @property
    def remainder_pattern(self) -> tuple[str, ...]:
        """Blocks past the last full pattern repetition (e.g. RecurrentGemma's
        38 = 12×(r,r,a) + (r,r)); applied unscanned after the stack."""
        return self.block_pattern[: self.n_layers % len(self.block_pattern)]

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class RunShape:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, RunShape] = {
    "train_4k": RunShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": RunShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": RunShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": RunShape("long_500k", 524_288, 1, "decode"),
}


def cell_applicable(cfg: ArchConfig, shape: RunShape) -> tuple[bool, str]:
    """Assignment skip rules (DESIGN.md §4)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch: 512k dense decode skipped"
    return True, ""


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests."""
    changes = dict(
        # one full pattern repetition + the original remainder (so the
        # unscanned-remainder path is exercised by smoke tests)
        n_layers=len(cfg.block_pattern) + cfg.n_layers % len(cfg.block_pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) or 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=512,
        encoder_layers=min(cfg.encoder_layers, 1),
        encoder_seq=min(cfg.encoder_seq, 16),
        vision_tokens=min(cfg.vision_tokens, 16),
        rnn_dim=64 if cfg.rnn_dim else 0,
        window=min(cfg.window, 8) if cfg.window else 0,
        attn_chunk=16,
        act_shard="none", grad_accum=1,
        param_dtype="float32",
        compute_dtype="float32",
        remat="none",
    )
    if cfg.moe is not None:
        # capacity_factor 4.0 → drop-free dispatch, so prefill/decode
        # consistency is exact in smoke tests (production keeps 1.25, which
        # drops overflow tokens by design — Switch semantics)
        changes["moe"] = MoEConfig(n_experts=4, top_k=cfg.moe.top_k,
                                   shared_expert=cfg.moe.shared_expert,
                                   capacity_factor=4.0)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
