"""grok-1-314b [moe]: 8 experts top-2.

64L, d_model=6144, 48H (GQA kv=8), d_ff=32768 per expert, vocab=131072.
[hf:xai-org/grok-1]
"""
from repro_torch.configs.base import (ArchConfig, MeshPlan, MoEConfig,
                                      register)


@register("grok-1-314b")
def config() -> ArchConfig:
    return ArchConfig(
        name="grok-1-314b", family="moe", source="hf:xai-org/grok-1",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=32768, vocab_size=131072,
        mlp_gated=True, norm="rmsnorm", pos_embed="rope",
        logit_softcap=30.0,
        moe=MoEConfig(num_experts=8, num_shared=0, top_k=2,
                      capacity_factor=1.25),
        # 314B params: must FSDP over the data axis as well.
        mesh_plan=MeshPlan(pipe=2, tensor=8, fsdp=True, num_microbatches=8),
        supports_long_context=False,
    )
