"""Transformer block assembly (twin of the dense branch of
``repro/models/transformer.py``).

A *block* = one layer: pre-norm attention and MLP, each with a residual.
The MoE, SSM and cross-attention branches come in later slices.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.models import attention as attn
from repro_torch.models.layers import (mlp_apply, mlp_specs, norm_apply,
                                       norm_specs)


def check_dense(cfg) -> None:
    """Raise for the families whose blocks are not ported yet."""
    missing = [name for name, on in (
        ("moe", cfg.moe is not None), ("mla", cfg.mla is not None),
        ("ssm", cfg.ssm is not None), ("enc-dec", cfg.is_encdec),
        ("frontend", cfg.frontend != "none"),
        ("pos_embed=" + cfg.pos_embed,
         cfg.pos_embed not in ("rope", "none"))) if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported to PyTorch yet; "
            f"the port runs dense decoder-only models")


def block_specs(cfg) -> Dict[str, Any]:
    check_dense(cfg)
    return {
        "ln1": norm_specs(cfg),
        "attn": attn.gqa_specs(cfg),
        "ln2": norm_specs(cfg),
        "mlp": mlp_specs(cfg),
    }


def block_apply(cfg, p, x, *, pos_offset: int = 0, causal: bool = True,
                cache: Optional[Dict] = None, pos: Optional[int] = None):
    """Returns (x, new_cache).  The JAX twin also returns an auxiliary
    loss and a recurrent state, which dense blocks leave at zero and
    None."""
    h, new_cache = attn.gqa_apply(
        cfg, p["attn"], norm_apply(cfg, p["ln1"], x),
        pos_offset=pos_offset, causal=causal, cache=cache, pos=pos)
    x = x + h
    x = x + mlp_apply(cfg, p["mlp"], norm_apply(cfg, p["ln2"], x))
    return x, new_cache
