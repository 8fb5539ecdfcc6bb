"""starcoder2-15b [dense]: GQA + RoPE code model.

40L, d_model=6144, 48H (GQA kv=4), d_ff=24576 (non-gated), vocab=49152.
[arXiv:2402.19173]
"""
from repro_torch.configs.base import ArchConfig, MeshPlan, register


@register("starcoder2-15b")
def config() -> ArchConfig:
    return ArchConfig(
        name="starcoder2-15b", family="dense", source="arXiv:2402.19173",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=4, head_dim=128,
        d_ff=24576, vocab_size=49152,
        mlp_gated=False, norm="layernorm", pos_embed="rope",
        mesh_plan=MeshPlan(pipe=4, tensor=4, num_microbatches=8),
        supports_long_context=False,
    )
