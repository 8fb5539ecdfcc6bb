"""minicpm3-4b [dense]: Multi-head Latent Attention (MLA).

62L, d_model=2560, 40H (kv=40 latent-compressed), d_ff=6400, vocab=73448.
[hf:openbmb/MiniCPM3-4B]

The port's copy of ``repro/configs/minicpm3_4b.py``: q.k width 64 + 32,
v width 64, tied embeddings.
"""
from repro_torch.configs.base import ArchConfig, MeshPlan, MLAConfig, register


@register("minicpm3-4b")
def config() -> ArchConfig:
    return ArchConfig(
        name="minicpm3-4b", family="dense", source="hf:openbmb/MiniCPM3-4B",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=6400, vocab_size=73448,
        mlp_gated=True, norm="rmsnorm", pos_embed="rope",
        mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256,
                      qk_nope_head_dim=64, qk_rope_head_dim=32,
                      v_head_dim=64),
        tie_embeddings=True,
        mesh_plan=MeshPlan(pipe=2, tensor=8, num_microbatches=4),
        supports_long_context=False,
    )
