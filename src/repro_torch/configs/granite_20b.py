"""granite-20b [dense]: gpt-bigcode-arch code model, MQA.

52L, d_model=6144, 48H (GQA kv=1 = MQA), d_ff=24576 (non-gated), vocab=49152.
[arXiv:2405.04324]
"""
from repro_torch.configs.base import ArchConfig, MeshPlan, register


@register("granite-20b")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-20b", family="dense", source="arXiv:2405.04324",
        n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
        d_ff=24576, vocab_size=49152,
        mlp_gated=False, norm="layernorm", pos_embed="rope",
        mesh_plan=MeshPlan(pipe=4, tensor=4, num_microbatches=8),
        supports_long_context=False,
    )
