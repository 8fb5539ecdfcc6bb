"""Architecture configuration for the PyTorch port.

The port's own copy of the JAX package's ``configs/base.py``: the same
frozen ``ArchConfig`` and sub-configs, field for field, so a config
built here describes the same model as its twin.  Every architecture
of the JAX package is registered; ``models.transformer.check_ported``
refuses the one whose reference model does not exist
(``residual-lstm-paper``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# helpers


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# sub-configs


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0            # routed experts
    num_shared: int = 0             # always-on shared experts (DeepSeekMoE)
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    router_jitter: float = 0.0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba2"            # "mamba2" | "rwkv6"
    d_state: int = 64
    head_dim: int = 64
    expand: int = 2                 # d_inner = expand * d_model
    conv_kernel: int = 4            # mamba2 short conv
    n_groups: int = 1               # mamba2 B/C groups
    # zamba2 hybrid: indices (within a stage) where the shared attention
    # block fires.  Empty for pure SSM models.
    shared_attn_every: int = 0      # fire shared block every k ssm layers


@dataclass(frozen=True)
class MeshPlan:
    """How the physical `model` mesh axis (size 16) factors logically.

    pipe * tensor must equal the model-axis size.  ``pipe_role`` says what
    the `pipe` sub-axis is used for: "stage" (pipeline parallelism) or
    "context" (sequence/context parallelism, used when the model is too
    small to pipeline, e.g. whisper-base).
    """
    pipe: int = 4
    tensor: int = 4
    pipe_role: str = "stage"        # "stage" | "context"
    fsdp: bool = False              # shard params over the data axis too
    # streaming pipeline: microbatches in flight == pipe stages; the sync
    # pipeline uses num_microbatches >= pipe.
    num_microbatches: int = 8


@dataclass(frozen=True)
class ArchConfig:
    # identity ------------------------------------------------------------
    name: str = "unnamed"
    family: str = "dense"           # dense|moe|ssm|hybrid|encdec|vlm|audio
    source: str = ""

    # transformer dims ------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 0               # 0 -> d_model // n_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    mlp_gated: bool = True          # SwiGLU (3 mats) vs GELU (2 mats)
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    pos_embed: str = "rope"         # rope | sinusoidal | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0      # grok-style tanh soft-capping (0 = off)

    # enc-dec (whisper) ------------------------------------------------------
    n_enc_layers: int = 0           # >0 => encoder-decoder
    enc_seq_ratio: float = 1.0      # encoder seq = ratio * seq_len

    # modality frontend stub -------------------------------------------------
    frontend: str = "none"          # none | audio | vision
    frontend_patches: int = 256     # vision: #positions replaced by patches

    # optional modules -------------------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None

    # numerics ---------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"             # full | dots | none

    # distribution ------------------------------------------------------------
    mesh_plan: MeshPlan = field(default_factory=MeshPlan)
    # which shapes this arch supports (long_500k only for sub-quadratic)
    supports_long_context: bool = False

    # ----------------------------------------------------------- derived
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab_size, 1024)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def attn_free(self) -> bool:
        return self.ssm is not None and (self.ssm.shared_attn_every == 0)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------ params
    def param_count(self) -> int:
        """Analytic parameter count (used by tests & comm-volume bench)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.hd
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd

        def attn_params(dm: int) -> int:
            return dm * n_q + 2 * dm * n_kv + n_q * dm

        def mlp_params() -> int:
            mats = 3 if self.mlp_gated else 2
            return mats * d * ff

        if self.mla is not None:
            m = self.mla
            qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads * qk_hd
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads
                    * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            attn = attn_params(d)

        if self.ssm is not None and self.ssm.kind == "rwkv6":
            tm = 5 * d * d                  # r,k,v,g,o projections
            tm += 2 * d * (5 * 32)          # ddlerp mix loras
            tm += 2 * d * 64                # decay lora
            cm = d * ff + ff * d + d * d    # channel mix: k, v, r
            per_layer = tm + cm
            total = self.n_layers * per_layer
        elif self.ssm is not None:  # mamba2 (possibly hybrid)
            s = self.ssm
            d_in = s.expand * d
            n_h = d_in // s.head_dim
            in_p = d * (2 * d_in + 2 * s.n_groups * s.d_state + n_h)
            out_p = d_in * d
            conv = (d_in + 2 * s.n_groups * s.d_state) * s.conv_kernel
            per_layer = in_p + out_p + conv + n_h * 3  # A/D/dt_bias per head
            total = self.n_layers * per_layer
            if s.shared_attn_every:
                shared_blocks = self.mesh_plan.pipe  # one per stage
                total += shared_blocks * (attn_params(d) + mlp_params())
        elif self.moe is not None:
            mo = self.moe
            expert = (3 if self.mlp_gated else 2) * d * ff
            per_layer = attn + (mo.num_experts + mo.num_shared) * expert \
                + d * mo.num_experts
            total = self.n_layers * per_layer
        else:
            per_layer = attn + mlp_params()
            total = self.n_layers * per_layer

        if self.is_encdec:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = self.n_enc_layers * (attn + mlp_params())
            dec = self.n_layers * (2 * attn + mlp_params())
            total = enc + dec

        emb = V * d * (1 if self.tie_embeddings else 2)
        return int(total + emb)

    def active_param_count(self) -> int:
        """Per-token active params (MoE: only top-k + shared experts)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        expert = (3 if self.mlp_gated else 2) * self.d_model * self.d_ff
        inactive = self.n_layers * (mo.num_experts - mo.top_k) * expert
        return self.param_count() - int(inactive)


# ---------------------------------------------------------------------------
# input shapes (assigned to every LM arch): the dry-run's cells


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs; returns (ok, reason-if-skipped)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: 500k dense decode skipped "
                       "per brief (needs sub-quadratic attention)")
    return True, ""


# ---------------------------------------------------------------------------
# registry

_REGISTRY: Dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def arch_config(name: str) -> ArchConfig:
    """Any architecture's config, for cost arithmetic (the figure twins
    in ``repro_torch.bench``): :func:`get_config`."""
    return get_config(name)


def list_archs() -> Tuple[str, ...]:
    # the ten assigned architectures
    return (
        "whisper-base", "pixtral-12b", "granite-8b", "granite-20b",
        "starcoder2-15b", "minicpm3-4b", "grok-1-314b", "deepseek-moe-16b",
        "rwkv6-7b", "zamba2-1.2b",
    )


def get_config(name: str) -> ArchConfig:
    if name in _REGISTRY:
        return _REGISTRY[name]()
    raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")


def smoke_config(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    kw: Dict[str, Any] = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=min(4, cfg.n_kv_heads),
        head_dim=16, d_ff=128, vocab_size=256,
        mesh_plan=dataclasses.replace(cfg.mesh_plan, pipe=1, tensor=1,
                                      num_microbatches=2, fsdp=False),
        remat="none",
    )
    if cfg.is_encdec:
        kw["n_enc_layers"] = 2
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2,
            num_shared=min(1, cfg.moe.num_shared))
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                              qk_nope_head_dim=16, qk_rope_head_dim=8,
                              v_head_dim=16)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16,
            shared_attn_every=(2 if cfg.ssm.shared_attn_every else 0))
    return cfg.replace(**kw)
