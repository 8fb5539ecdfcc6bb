"""rwkv6-7b [ssm]: RWKV-6 "Finch" — attention-free, data-dependent decay.

32L, d_model=4096 (64 heads of 64), d_ff=14336, vocab=65536.
[arXiv:2404.05892]
"""
from repro_torch.configs.base import ArchConfig, MeshPlan, SSMConfig, register


@register("rwkv6-7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="rwkv6-7b", family="ssm", source="arXiv:2404.05892",
        n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
        d_ff=14336, vocab_size=65536,
        norm="layernorm", pos_embed="none",
        ssm=SSMConfig(kind="rwkv6", head_dim=64),
        mesh_plan=MeshPlan(pipe=4, tensor=4, num_microbatches=8),
        supports_long_context=True,
    )
