"""deepseek-moe-16b [moe]: fine-grained 64 routed top-6 + 2 shared experts.

28L, d_model=2048, 16H (kv=16 = MHA), d_ff=1408 per expert, vocab=102400.
[arXiv:2401.06066]
"""
from repro_torch.configs.base import (ArchConfig, MeshPlan, MoEConfig,
                                      register)


@register("deepseek-moe-16b")
def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-moe-16b", family="moe", source="arXiv:2401.06066",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=1408, vocab_size=102400,
        mlp_gated=True, norm="rmsnorm", pos_embed="rope",
        moe=MoEConfig(num_experts=64, num_shared=2, top_k=6,
                      capacity_factor=1.25),
        mesh_plan=MeshPlan(pipe=2, tensor=8, num_microbatches=4),
        supports_long_context=False,
    )
