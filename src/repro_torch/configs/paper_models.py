"""The paper's own six benchmark models (§4.1): the port's copy of
``repro/configs/paper_models.py``.

SNN / Transformer / Residual-LSTM are trainable configs used by the
convergence + RMSE reproductions.  The three CNNs are represented as
byte-level models (exact parameter & inter-stage activation sizes) for the
Fig. 3/4 communication-volume study — see DESIGN.md §6.
"""
from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import ArchConfig, MeshPlan, register


@register("snn-paper")
def snn() -> ArchConfig:
    """SNN (Klambauer et al. 2017): 32 FC layers x 2048 hidden units."""
    return ArchConfig(
        name="snn-paper", family="fcn", source="paper §4.1",
        n_layers=32, d_model=2048, n_heads=1, n_kv_heads=1, head_dim=2048,
        d_ff=2048, vocab_size=3072,  # cifar10: 32*32*3 input, 10 classes
        mlp_gated=False, norm="layernorm", pos_embed="none",
        mesh_plan=MeshPlan(pipe=4, tensor=4, num_microbatches=8),
    )


@register("transformer-paper")
def transformer() -> ArchConfig:
    """Transformer (Vaswani 2017) as used by the paper: 6 enc + 6 dec blocks,
    8 heads, 512 hidden; IMDb sentiment, inputs truncated to 20 words."""
    return ArchConfig(
        name="transformer-paper", family="encdec", source="paper §4.1",
        n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
        head_dim=64, d_ff=2048, vocab_size=30000,
        mlp_gated=False, norm="layernorm", pos_embed="sinusoidal",
        mesh_plan=MeshPlan(pipe=2, tensor=8, pipe_role="context",
                           num_microbatches=4),
    )


@register("residual-lstm-paper")
def residual_lstm() -> ArchConfig:
    """Residual LSTM (Kim et al. 2017): 8 LSTM layers, 512 emb/out, 1024 mem.

    Implemented in models/rnn.py; config reuses the ssm slot semantics
    (recurrent family) but with its own apply path.
    """
    return ArchConfig(
        name="residual-lstm-paper", family="rnn", source="paper §4.1",
        n_layers=8, d_model=512, n_heads=1, n_kv_heads=1, head_dim=512,
        d_ff=1024, vocab_size=30000,
        mlp_gated=False, norm="layernorm", pos_embed="none",
        mesh_plan=MeshPlan(pipe=4, tensor=4, num_microbatches=8),
    )


# ---------------------------------------------------------------------------
# CNN byte models for the Fig.3 / Fig.4 communication study


@dataclass(frozen=True)
class CNNByteModel:
    name: str
    params: int                    # total weights
    # bytes of intermediate activations crossing a 4-way pipeline cut,
    # per sample (forward); backward doubles it.
    stage_cut_activations: Tuple[int, ...]  # per cut, elements per sample


CNN_MODELS = (
    # VGG16: 138M params; cuts after conv blocks 2/3/4: 128x56x56 etc.
    CNNByteModel("vgg16", 138_357_544,
                 (128 * 56 * 56, 256 * 28 * 28, 512 * 14 * 14)),
    # ResNet-152: 60.2M params; cuts between res stages
    CNNByteModel("resnet152", 60_192_808,
                 (256 * 56 * 56, 512 * 28 * 28, 1024 * 14 * 14)),
    # Inception v4: 42.7M params; cuts between inception stacks
    CNNByteModel("inception_v4", 42_679_816,
                 (384 * 35 * 35, 1024 * 17 * 17, 1536 * 8 * 8)),
)
