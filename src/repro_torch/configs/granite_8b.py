"""granite-8b [dense]: llama-arch code model.

36L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=49152.
[arXiv:2405.04324]
"""
from repro_torch.configs.base import ArchConfig, MeshPlan, register


@register("granite-8b")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-8b", family="dense", source="arXiv:2405.04324",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=49152,
        mlp_gated=True, norm="rmsnorm", pos_embed="rope",
        mesh_plan=MeshPlan(pipe=4, tensor=4, num_microbatches=8),
        supports_long_context=False,
    )
