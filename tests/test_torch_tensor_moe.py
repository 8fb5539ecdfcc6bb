"""The tensor axis for the MoE decoders (``--tensor 2``: the routed
experts split on their expert dim, the router on its expert columns,
deepseek's shared experts on ``mlp``, attention as the dense decoders')
held on the CPU to the JAX package's unsharded steps, through
``test_torch_tensor_axis``'s harness.

Claims (rtol 1e-4 / atol 1e-5):
  * deepseek-moe-16b and grok-1-314b smokes at ``--tensor 2``: the tick,
    ``--mode sync`` and the 1f1b round against JAX's unsharded steps
    (losses step by step, every leaf gathered at the end: the router's
    gradient from the replicated aux loss and the gates included); the
    tick's tensor all-reduces and their bytes exact;
  * each rank's leaf shapes are JAX's ``spec_for_leaf(logical_rules)``
    blocks, at smoke size and at full size over tensor 2, 4 and 8;
  * the rank's local dispatch (its ``E / T`` experts, the others' pairs
    adding zero) summed over the ranks is the whole layer's output;
  * ``--data 2 --tensor 2`` on deepseek against one process, and its
    checkpoint restored at ``--data 1 --tensor 1`` equal to the
    gathered state;
  * an expert count the tensor size does not divide, or shared experts
    whose d_ff it does not divide, is refused in three parts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch import train
from repro_torch.models import moe
from repro_torch.runtime import sharding as rsh
from test_torch_tensor_axis import (BASE, SCHEDULES, _argv, check_against_jax,
                                    check_grid, check_leaf_split, rank_runs,
                                    tp_cases)
from test_torch_threads import one_thread  # noqa: F401

ARCHS = ("deepseek-moe-16b", "grok-1-314b")


def _layer_sum(group):
    """One smoke MoE layer (deepseek, G 16, a capacity that drops pairs)
    on this tensor rank, and the whole layer in one process: (the ranks'
    outputs summed through the layer's reduction, the whole output)."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.models import tensor_axis as tp
    from repro_torch.models.layers import init_params
    cfg = smoke_config(get_config("deepseek-moe-16b"))
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.6))
    specs = moe.moe_specs(cfg)
    whole = init_params(specs, torch.Generator().manual_seed(1))
    dims = {"router": -1, "wg": -3, "w1": -3, "w2": -3, "shared_wg": -1,
            "shared_w1": -1, "shared_w2": -2}
    t, T = group.tensor.rank, group.tensor.world
    mine = {k: rsh.tensor_leaf((k,), v, dims, t, T) for k, v in
            whole.items()}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    with tp.tensor_axis(group.tensor):
        got, aux = moe.moe_apply(cfg, mine, x)
    want, waux = moe.moe_apply(cfg, whole, x)
    return tuple(t.detach().numpy() for t in (got, want, aux, waux))


def _ranks(group):
    out = tp_cases(group, ARCHS)
    out["layer"] = _layer_sum(group)
    return out


@pytest.fixture(scope="module")
def runs():
    yield from rank_runs(_ranks)


def tp_per_tick(cfg, L: int, mb: int, seq: int, el: int = 4) -> tuple:
    """(calls, bytes) of a spectrain tick's tensor all-reduces a rank, an
    MoE decoder of L layers on microbatches of ``mb`` x ``seq`` tokens in
    a compute dtype of ``el`` bytes: the inject's embedding, the head's
    max / sum of exponentials / gold logit ([mb, seq] fp32), its input's
    cotangent and the embedding backward's lookup; a layer forwards (and
    recomputes) attention's row-parallel output, the router made whole
    ([d, E]) and the routed plus shared output, and backward sums the
    cotangents of attention's input, the gates ([mb·seq, k]) and the
    tokens entering the experts (and a replicated K/V's gradients)."""
    A = mb * seq * cfg.d_model * el
    kv_rep = cfg.n_kv_heads % 2 != 0
    calls = 6 + L * (9 + 2 * kv_rep)
    nbytes = (3 * A + 3 * mb * seq * 4 + L * (
        6 * A + 2 * cfg.d_model * cfg.moe.num_experts * el
        + mb * seq * cfg.moe.top_k * el)
        + L * kv_rep * 2 * cfg.d_model * cfg.n_kv_heads * cfg.hd * 4)
    return calls, nbytes


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_two_matches_jax_unsharded(arch, sched, runs):
    args = train.parse_args(_argv(arch, sched))
    cfg = train.build(args)
    check_against_jax(arch, sched, runs(),
                      *tp_per_tick(cfg, args.layers, args.batch, args.seq))


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_split_is_jax_spec_for_leaf(arch, runs):
    check_leaf_split(arch, runs()[0][(arch, "sync")][2])
    for T in (4, 8):
        check_leaf_split(arch, None, T)


def test_local_dispatch_sums_to_the_whole_layer(runs):
    """The ranks' outputs (each its experts' pairs and its shared
    columns, summed by the one reduction) equal the one-process layer at
    1e-6, and the aux loss, replicated, bit for bit."""
    for r in range(2):
        got, want, aux, waux = runs()[r]["layer"]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert np.array_equal(aux, waux)


def test_grid_with_moe_matches_one_process(tmp_path):
    check_grid(tmp_path, BASE + ["--arch", "deepseek-moe-16b"],
               resume=False)


@pytest.mark.parametrize("arch,change,T,what", [
    ("grok-1-314b", {"num_experts": 6}, 4, "6 MoE experts of d_ff 32768"),
    ("deepseek-moe-16b", {"d_ff": 1410}, 4, "64 MoE experts of d_ff 1410"),
])
def test_expert_count_tensor_does_not_divide_is_refused(arch, change, T,
                                                        what):
    """An expert count T does not divide, or shared experts whose d_ff it
    does not divide, is refused in three parts; the registered configs
    split at T 8."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    assert rsh.tensor_refusal(cfg, 8) is None
    cfg = (cfg.replace(moe=dataclasses.replace(cfg.moe, **change))
           if "num_experts" in change else cfg.replace(**change))
    msg = rsh.tensor_refusal(cfg, T)
    assert msg.startswith(f"unsupported combination: --tensor {T} with "
                          f"{arch}'s {what} — ") and \
        "; supported alternative: " in msg, msg
