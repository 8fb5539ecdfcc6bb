"""Transformer block assembly (twin of ``repro/models/transformer.py``).

A *block* = one layer: for dense and MoE models pre-norm attention (GQA,
or MLA when the config has ``mla``: ``attention.attn_apply`` dispatches)
and MLP (or MoE), each with a residual; an enc-dec decoder block adds a
pre-norm cross-attention residual between the two (``lnx``, ``xattn``);
for rwkv6 time-mix and channel-mix; for mamba2 (the zamba2 backbone) a
norm, the Mamba-2 mixer and a residual.  zamba2's shared attention block
(attention + MLP, one per pipeline stage) is :func:`shared_block_apply`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (mlp_apply, mlp_specs, norm_apply,
                                       norm_specs)


def check_ported(cfg) -> None:
    """Raise for the recurrent family, whose reference model does not
    exist."""
    if cfg.family == "rnn":
        raise NotImplementedError(
            f"{cfg.name}: family 'rnn' is not ported to PyTorch: its "
            f"reference model does not exist (the JAX config, "
            f"repro/configs/paper_models.py, names models/rnn.py, which "
            f"the JAX package does not have), and its dimensions would "
            f"build dense attention blocks, another model")


def block_specs(cfg, cross: bool = False) -> Dict[str, Any]:
    """One layer's specs; ``cross``: an enc-dec decoder layer's, with
    cross-attention (``lnx``, ``xattn``)."""
    check_ported(cfg)
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return {
            "ln1": norm_specs(cfg),
            "tm": ssm_mod.rwkv6_tm_specs(cfg),
            "ln2": norm_specs(cfg),
            "cm": ssm_mod.rwkv6_cm_specs(cfg),
        }
    if cfg.ssm is not None:
        # zamba2-style mamba block: norm + mamba mixer + residual (no MLP)
        return {"ln1": norm_specs(cfg), "mamba": ssm_mod.mamba2_specs(cfg)}
    specs: Dict[str, Any] = {
        "ln1": norm_specs(cfg),
        "attn": attn.attn_specs(cfg),
        "ln2": norm_specs(cfg),
    }
    if cross:
        specs["lnx"] = norm_specs(cfg)
        specs["xattn"] = attn.gqa_specs(cfg)
    if cfg.moe is not None:
        specs["moe"] = moe_mod.moe_specs(cfg)
    else:
        specs["mlp"] = mlp_specs(cfg)
    return specs


def shared_block_specs(cfg) -> Dict[str, Any]:
    """zamba2 shared attention block: full attention + MLP."""
    return {
        "ln1": norm_specs(cfg),
        "attn": attn.attn_specs(cfg),
        "ln2": norm_specs(cfg),
        "mlp": mlp_specs(cfg),
    }


def block_apply(cfg, p, x, *, pos_offset: int = 0, causal: bool = True,
                cache: Optional[Dict] = None, pos=None, pages=None,
                state: Optional[Dict] = None,
                wave_len: Optional[int] = None, enc_out=None,
                cross_kv: Optional[Dict] = None):
    """Returns (x, aux, new_cache, new_state), the JAX twin's tuple.
    ``aux`` is an MoE block's load-balance loss (0-d fp32) and None for
    the blocks without a router, where the JAX twin returns a zero: so
    the dense and SSM paths add no kernel for it.  Dense blocks use
    ``cache`` (and return no state); with ``pages`` (and ``pos`` an
    int32 tensor, one position per row) theirs is the pipelined
    engine's decode wave over a paged buffer
    (``attention.gqa_decode_wave``, or ``mla_decode_wave``, which
    expands the rows' latents up to ``wave_len`` positions).  rwkv6 and
    mamba2 blocks use ``state``, update it in place and return its
    leaves (and no cache).  An enc-dec decoder block (one with
    ``xattn``) attends to the encoder's output ``enc_out`` [b, sk, d],
    or, serving, to its layer's cached cross keys and values
    ``cross_kv`` (``{"k", "v": [b, sk, KV, hd]}``).

    A call with a cache, pages or a state serves; there an MoE block
    routes each token alone (``moe.moe_apply_tokens``), as the JAX
    engines' one-token decode steps do.  A call with none of them is a
    training or reference forward and dispatches grouped, with
    capacity (``moe.moe_apply``)."""
    if cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        h, st_tm = ssm_mod.rwkv6_tm_apply(
            cfg, p["tm"], norm_apply(cfg, p["ln1"], x), state)
        x = x + h
        h, st_cm = ssm_mod.rwkv6_cm_apply(
            cfg, p["cm"], norm_apply(cfg, p["ln2"], x), state)
        x = x + h
        new_state = {**st_tm, **st_cm} if state is not None else None
        return x, None, None, new_state

    if cfg.ssm is not None:
        h, new_state = ssm_mod.mamba2_apply(
            cfg, p["mamba"], norm_apply(cfg, p["ln1"], x), state)
        return x + h, None, None, new_state

    h, new_cache = attn.attn_apply(
        cfg, p["attn"], norm_apply(cfg, p["ln1"], x),
        pos_offset=pos_offset, causal=causal, cache=cache, pos=pos,
        pages=pages, wave_len=wave_len)
    x = x + h
    if "xattn" in p:
        xq = norm_apply(cfg, p["lnx"], x)
        if cross_kv is not None:
            h = attn.cross_attend(cfg, p["xattn"], xq, cross_kv)
        else:
            if enc_out is None:
                raise ValueError("a decoder block needs enc_out or "
                                 "cross_kv")
            h, _ = attn.gqa_apply(cfg, p["xattn"], xq, causal=False,
                                  kv_input=enc_out)
        x = x + h
    xn = norm_apply(cfg, p["ln2"], x)
    aux = None
    if "moe" in p:
        serving = cache is not None or pages is not None
        apply = moe_mod.moe_apply_tokens if serving else moe_mod.moe_apply
        h, aux = apply(cfg, p["moe"], xn)
    else:
        h = mlp_apply(cfg, p["mlp"], xn)
    return x + h, aux, new_cache, None


def shared_block_apply(cfg, p, x, *, pos_offset: int = 0,
                       cache: Optional[Dict] = None,
                       pos: Optional[int] = None):
    """Returns (x, new_cache): causal attention (through the flash
    kernel) and the MLP, each with a pre-norm residual."""
    h, new_cache = attn.attn_apply(cfg, p["attn"],
                                  norm_apply(cfg, p["ln1"], x),
                                  pos_offset=pos_offset, causal=True,
                                  cache=cache, pos=pos)
    x = x + h
    x = x + mlp_apply(cfg, p["mlp"], norm_apply(cfg, p["ln2"], x))
    return x, new_cache
