"""pixtral-12b [vlm]: pixtral-ViT frontend (stub) + mistral-nemo backbone.

40L, d_model=5120, 32H (GQA kv=8, head_dim=128), d_ff=14336, vocab=131072.
[hf:mistralai/Pixtral-12B-2409]

The port's copy of ``repro/configs/pixtral_12b.py``.
"""
from repro_torch.configs.base import ArchConfig, MeshPlan, register


@register("pixtral-12b")
def config() -> ArchConfig:
    return ArchConfig(
        name="pixtral-12b", family="vlm",
        source="hf:mistralai/Pixtral-12B-2409",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=131072,
        mlp_gated=True, norm="rmsnorm", pos_embed="rope", rope_theta=1e6,
        frontend="vision", frontend_patches=256,
        mesh_plan=MeshPlan(pipe=4, tensor=4, num_microbatches=8),
        supports_long_context=False,
    )
