"""The tensor axis for multi-head latent attention (``--tensor 2`` on
minicpm3-4b: ``w_uq`` / ``w_ukv`` column-parallel on the heads, ``wo``
row-parallel, the latents, their norms and the shared rope key computed
on every rank; the MLP and the tied vocabulary as the dense decoders')
held on the CPU to the JAX package's unsharded steps, through
``test_torch_tensor_axis``'s harness.

Claims (rtol 1e-4 / atol 1e-5):
  * the minicpm3-4b smoke at ``--tensor 2``: the tick, ``--mode sync``
    and the 1f1b round against JAX's unsharded steps (losses step by
    step, every leaf gathered at the end: the replicated ``w_dq``,
    ``w_dkv`` and norms, and the tied embedding, included); the tick's
    tensor all-reduces and their bytes exact;
  * each rank's leaf shapes are JAX's ``spec_for_leaf(logical_rules)``
    blocks, at smoke size and at full size over tensor 2, 4 and 8;
  * one MLA layer's output on the two ranks, summed by its reduction,
    equals the one-process layer (the flash plain version at (q.k, v)
    widths of the smoke).
"""
import numpy as np
import pytest
import torch

from repro_torch.launch import train
from repro_torch.models import attention
from repro_torch.runtime import sharding as rsh
from test_torch_tensor_axis import (SCHEDULES, _argv, check_against_jax,
                                    check_leaf_split, rank_runs, tp_cases)
from test_torch_threads import one_thread  # noqa: F401

ARCH = "minicpm3-4b"


def _layer(group):
    """One smoke MLA layer on this tensor rank and in one process."""
    from repro_torch.models import tensor_axis as tp
    from repro_torch.models.layers import init_params
    cfg = train.build(train.parse_args(_argv(ARCH, "tick")))
    specs = attention.mla_specs(cfg)
    whole = init_params(specs, torch.Generator().manual_seed(3))
    dims = {"w_uq": -1, "w_ukv": -1, "wo": -2}
    t, T = group.tensor.rank, group.tensor.world
    mine = {k: rsh.tensor_leaf((k,), v, dims, t, T) if not isinstance(
        v, dict) else v for k, v in whole.items()}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    with tp.tensor_axis(group.tensor):
        got, _ = attention.mla_apply(cfg, mine, x)
    want, _ = attention.mla_apply(cfg, whole, x)
    return got.numpy(), want.numpy()


def _ranks(group):
    out = tp_cases(group, (ARCH,))
    out["layer"] = _layer(group)
    return out


@pytest.fixture(scope="module")
def runs():
    yield from rank_runs(_ranks)


def tp_per_tick(cfg, L: int, mb: int, seq: int, el: int = 4) -> tuple:
    """(calls, bytes) of a spectrain tick's tensor all-reduces a rank, an
    MLA decoder of L layers on microbatches of ``mb`` x ``seq`` tokens in
    a compute dtype of ``el`` bytes: the head's and the embedding's 6 as
    the dense decoders'; a layer forwards (and recomputes) the row-
    parallel outputs of ``wo`` and the MLP, and backward sums the
    cotangents of the normed query latent, the normed ``c_kv``, the rope
    key and the MLP's input."""
    A = mb * seq * cfg.d_model * el
    m = cfg.mla
    lat = mb * seq * (m.q_lora_rank + m.kv_lora_rank + m.qk_rope_head_dim)
    return 6 + 8 * L, 3 * A + 3 * mb * seq * 4 + L * (5 * A + lat * el)


@pytest.mark.parametrize("sched", list(SCHEDULES))
def test_tensor_two_matches_jax_unsharded(sched, runs):
    args = train.parse_args(_argv(ARCH, sched))
    cfg = train.build(args)
    check_against_jax(ARCH, sched, runs(),
                      *tp_per_tick(cfg, args.layers, args.batch, args.seq))


def test_leaf_split_is_jax_spec_for_leaf(runs):
    check_leaf_split(ARCH, runs()[0][(ARCH, "sync")][2])
    for T in (4, 8):
        check_leaf_split(ARCH, None, T)


def test_mla_layer_on_two_ranks_is_the_whole_layer(runs):
    for r in range(2):
        got, want = runs()[r]["layer"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("T", [2, 4, 8])
def test_leaf_names_shard_on_one_dim_in_every_config(T):
    """``tensor_leaf_dims`` keys a leaf's dim by its name: no registered
    config that the tensor axis takes repeats a name on two dims at T
    (MoE's ``w1`` on its expert dim, -3, and a dense ``mlp/w1`` on -1 sit
    in no one model; rwkv6's ``wk`` and attention's neither), so the
    name is enough; a refused config is skipped."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.models import Model
    seen = 0
    for arch in list_archs():
        cfg = get_config(arch)
        if cfg.family == "rnn" or rsh.tensor_refusal(cfg, T):
            continue
        dims = rsh.tensor_leaf_dims(cfg, Model(cfg, device="meta"), T)
        assert dims, arch
        if cfg.moe is not None and cfg.moe.num_experts % T == 0:
            assert dims["w1"] == -3 and dims["router"] == -1, arch
        seen += 1
    assert seen >= 8
