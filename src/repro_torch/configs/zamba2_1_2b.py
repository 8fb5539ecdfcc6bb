"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks.

38L, d_model=2048, shared attn 32H (kv=32), d_ff=8192, ssm_state=64,
vocab=32000.  [arXiv:2411.15242]
"""
from repro_torch.configs.base import ArchConfig, MeshPlan, SSMConfig, register


@register("zamba2-1.2b")
def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b", family="hybrid", source="arXiv:2411.15242",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=32000,
        mlp_gated=False, norm="rmsnorm", pos_embed="rope",
        ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2,
                      conv_kernel=4, n_groups=1, shared_attn_every=10),
        tie_embeddings=True,
        mesh_plan=MeshPlan(pipe=2, tensor=8, num_microbatches=4),
        supports_long_context=True,
    )
