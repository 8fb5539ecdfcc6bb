"""whisper-base [audio]: enc-dec, conv frontend stubbed to frame embeddings.

6L encoder + 6L decoder, d_model=512, 8H (kv=8), d_ff=2048, vocab=51865.
[arXiv:2212.04356]

The port's copy of ``repro/configs/whisper_base.py``.
"""
from repro_torch.configs.base import ArchConfig, MeshPlan, register


@register("whisper-base")
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-base", family="audio", source="arXiv:2212.04356",
        n_layers=6, n_enc_layers=6,
        d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
        d_ff=2048, vocab_size=51865,
        mlp_gated=False, norm="layernorm", pos_embed="sinusoidal",
        frontend="audio", tie_embeddings=True,
        # too small to pipeline: model axis = 8-way TP x 2-way context par.
        mesh_plan=MeshPlan(pipe=2, tensor=8, pipe_role="context",
                           num_microbatches=4),
        supports_long_context=False,
    )
