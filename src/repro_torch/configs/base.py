"""Model / run configuration.

One ``ModelConfig`` describes any of the 10 assigned architectures (plus the
paper's own Kratos-DD workload config).  ``family`` selects the layer body:

* ``dense``  — standard decoder transformer (GQA/MQA, SwiGLU/GeGLU)
* ``moe``    — dense attention + routed-experts FFN (+ shared experts)
* ``ssm``    — Mamba-2 SSD blocks (attention-free)
* ``hybrid`` — parallel attention + SSD heads per layer (Hymba-style)
* ``encdec`` — encoder-decoder (Whisper backbone; conv frontend stubbed)
* ``vlm``    — decoder over mixed patch+token embeddings (LLaVA backbone;
               anyres tiling frontend stubbed)

A copy of ``repro/configs/base.py``.  ``use_kernels`` is kept so that
configs read the same in both packages, but in this package it does not
choose the attention route: the device does (a CUDA tensor launches the
hand-written kernel, a CPU tensor runs its plain version; see
:mod:`repro_torch.kernels.ops`).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None     # default d_model // n_heads
    act: str = "swiglu"             # swiglu | geglu
    qkv_bias: bool = False           # qwen1.5
    logit_softcap: float | None = None   # gemma2
    attn_softcap: float | None = None
    # local/global attention pattern: window size for local layers; pattern
    # "lg" = alternate local, global (gemma2); None = all global
    local_window: int | None = None
    layer_pattern: str | None = None
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    rms_eps: float = 1e-6
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0          # leading dense layers (deepseek/kimi)
    capacity_factor: float = 1.25
    moe_group_size: int = 4096
    # --- SSM (mamba2 / hymba) ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    conv_kernel: int = 4
    # --- enc-dec ---
    n_encoder_layers: int = 0
    encoder_seq: int = 0
    # --- vlm ---
    n_patches: int = 0
    # --- runtime ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    use_kernels: bool = False        # Pallas path (TPU); False = jnp ref path
    loss_chunk: int = 2048           # sequence-chunked CE for huge vocabs
    # --- perf variants (§Perf hillclimbing) ---
    kv_cache_dtype: str = "bfloat16"   # "int8": quantized KV cache
    unroll_layers: bool = False        # python-loop layers: enables static
    #                                    per-layer windows (chunked SWA)
    chunked_local_attn: bool = False   # block-local attention for SWA layers
    ssd_chunk: int = 0                 # SSD chunked-dual form (0 = serial)

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(2, self.n_layers),
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, 4 * self.n_kv_heads // max(1, self.n_heads)),
            head_dim=16,
            d_ff=128,
            vocab=256,
            param_dtype="float32",
            compute_dtype="float32",
            remat=False,
            moe_group_size=64,
            loss_chunk=64,
        )
        if self.is_moe:
            kw.update(n_experts=4, n_shared_experts=min(1, self.n_shared_experts),
                      top_k=2, d_ff_expert=32, n_dense_layers=min(1, self.n_dense_layers))
        if self.ssm_state:
            kw.update(ssm_state=8, ssm_heads=4, ssm_head_dim=16)
        if self.family == "encdec":
            kw.update(n_encoder_layers=2, encoder_seq=32)
        if self.family == "vlm":
            kw.update(n_patches=8)
        if self.local_window:
            kw.update(local_window=16)
        return replace(self, **kw)


# registry filled by the per-arch modules
REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not REGISTRY:
        load_all()
    return REGISTRY[name]


def list_configs() -> list[str]:
    if not REGISTRY:
        load_all()
    return sorted(REGISTRY)


def load_all() -> None:
    from . import (deepseek_moe_16b, gemma2_2b, gemma_2b, hymba_1_5b,  # noqa
                   kimi_k2, kratos_dd, llava_next_34b, mamba2_2_7b,
                   qwen1_5_0_5b, tinyllama_1_1b, whisper_small)


# ---------------------------------------------------------------------------
# shapes (assigned input-shape sets)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: archs with a sub-quadratic long-context path (run long_500k); all others
#: skip it (see DESIGN.md §4)
LONG_CONTEXT_ARCHS = {"mamba2-2.7b", "hymba-1.5b"}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.name not in LONG_CONTEXT_ARCHS \
            and not cfg.name.endswith("-smoke"):
        return False, "full-attention arch: no sub-quadratic 500k path"
    return True, ""
