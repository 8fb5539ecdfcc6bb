"""The tensor axis for the state-space decoders (``--tensor 2``: rwkv6's
and mamba2's heads a rank, the scans at H / T heads, zamba2's shared
attention block as the dense decoders') held on the CPU to the JAX
package's unsharded steps, through ``test_torch_tensor_axis``'s harness.

Claims (rtol 1e-4 / atol 1e-5; rwkv6's leaves against JAX within its
envelope of ``test_torch_ssm_train``, rtol 1e-3 / 2e-3 of a leaf's
largest, which the one-process port needs as well):
  * rwkv6-7b and zamba2-1.2b smokes (``--layers 4``: each of zamba2's two
    stages fires its shared block, ``shared_attn_every`` 2) at
    ``--tensor 2``: the tick, ``--mode sync`` and the 1f1b round against
    JAX's unsharded steps (losses step by step, every leaf gathered at
    the end, the replicated ``mix_A``, ``w_bc`` and the rest included);
    the tick's tensor all-reduces and their bytes exact (rwkv6's decay
    cotangent in fp32, mamba2's gated norm's sums of squares);
  * each rank's leaf shapes are JAX's ``spec_for_leaf(logical_rules)``
    blocks, at smoke size and at full size over tensor 2 and 4 (rwkv6)
    or 2, 4 and 8 (zamba2);
  * mamba2's ``w_zx`` on a rank is the pair of its z and x blocks, and
    gathered over the ranks it is JAX's whole leaf (every leaf is); the
    clip norm over a rank's blocks is the whole tree's (1e-6);
  * ``--data 2 --tensor 2`` on zamba2 against one process, its
    checkpoint restored at ``--data 1 --tensor 1`` equal to the gathered
    state and a ``--data 2 --tensor 2`` resume from it bit-equal;
  * a mamba2 head count the tensor size does not divide is refused in
    three parts.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.runtime import sharding as rsh
from test_torch_tensor_axis import (BASE, SCHEDULES, _argv, check_against_jax,
                                    check_grid, check_leaf_split, rank_runs,
                                    tp_cases)
from test_torch_threads import one_thread  # noqa: F401

ARCHS = ("rwkv6-7b", "zamba2-1.2b")


def _pair(group):
    """(the rank's ``w_zx`` is its z and x blocks of the whole draw, every
    leaf of its draw gathered over the ranks equals the whole draw, the
    clip norm of its blocks (``sgd._tensor_norm``: the sharded leaves'
    squares summed over the ranks, the replicated ``w_bc``, conv and
    norm leaves counted once) over the whole draw's ``global_norm``)."""
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import sgd
    cfg = train.build(train.parse_args(_argv("zamba2-1.2b", "tick")))
    model = Model(cfg, device="cpu")
    t, T = group.tensor.rank, group.tensor.world
    whole = model.init(torch.Generator().manual_seed(0))
    mine = model.init(torch.Generator().manual_seed(0), tensor=(t, T))
    w, m = (p["stages"][0]["layers"]["mamba"]["w_zx"] for p in (whole, mine))
    d_in = w.shape[-1] // 2
    b = d_in // T
    pair = torch.equal(m, torch.cat([w[..., t * b:(t + 1) * b],
                                     w[..., d_in + t * b:d_in + (t + 1) * b]],
                                    -1))
    dims = rsh.tensor_leaf_dims(cfg, model, T)
    back = rsh.gather_tensor(mine, dims, group.tensor)
    norm = sgd._tensor_norm(mine, tree_leaves(mine), group.tensor, dims,
                            None)
    return pair, all(torch.equal(a, b) for a, b in
                     zip(tree_leaves(back), tree_leaves(whole))), \
        float(norm / sgd.global_norm(whole))


def _ranks(group):
    out = tp_cases(group, ARCHS)
    out["pair"] = _pair(group)
    return out


@pytest.fixture(scope="module")
def runs():
    yield from rank_runs(_ranks)


def tp_per_tick(cfg, L: int, S: int, mb: int, seq: int, el: int = 4
                ) -> tuple:
    """(calls, bytes) of a spectrain tick's tensor all-reduces a rank, an
    SSM decoder of L layers in S stages on microbatches of ``mb`` x
    ``seq`` tokens in a compute dtype of ``el`` bytes.  Beside the head
    and the embedding's 6 (as the dense decoders'), an rwkv6 layer
    forwards (and recomputes) its time and channel mixes' row-parallel
    outputs and backward sums the cotangents of the four mixes entering
    the heads (one [mb, seq, 4, d] call), of the decay (fp32) and of the
    channel mix's key input; a mamba2 layer forwards (and recomputes) the
    gated norm's sums of squares ([mb, seq, 1] fp32) and ``w_out``'s
    output, and backward sums the cotangents of x entering ``w_zx`` /
    ``w_dt``, of B and C and of the sums of squares; each firing of
    zamba2's shared block counts as a dense layer."""
    A = mb * seq * cfg.d_model * el
    l4 = mb * seq * 4
    calls, nbytes = 6, 3 * A + 3 * l4
    if cfg.ssm.kind == "rwkv6":
        calls += 7 * L
        nbytes += L * (9 * A + mb * seq * cfg.d_model * 4)
    else:
        bc = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
        calls += 7 * L
        nbytes += L * (3 * A + 3 * l4 + mb * seq * bc * el)
        k = cfg.ssm.shared_attn_every
        fires = S * ((L // S) // k)
        calls += 6 * fires
        nbytes += 6 * A * fires
    return calls, nbytes


def _rwkv6_tol(want):
    """rwkv6's envelope against JAX, ``test_torch_ssm_train``'s (PR 26):
    the one-process port is as far from JAX's steps as the tensor ranks
    are (the smoke model's conditioning carries XLA's CPU ``tanh`` and
    ``exp`` ulps, and here the ranks' reordered sums, into the embedding
    gradient: ~8e-4 of a 2.5 momentum leaf after 3 ticks, every other
    leaf within 1e-4)."""
    from test_torch_ssm_train import RWKV_ATOL, RWKV_RTOL
    return RWKV_RTOL, max(1e-5, RWKV_ATOL * float(np.abs(want).max()))


@pytest.mark.parametrize("sched", list(SCHEDULES))
@pytest.mark.parametrize("arch", ARCHS)
def test_tensor_two_matches_jax_unsharded(arch, sched, runs):
    args = train.parse_args(_argv(arch, sched))
    cfg = train.build(args)
    check_against_jax(arch, sched, runs(),
                      *tp_per_tick(cfg, args.layers, args.pipe, args.batch,
                                   args.seq),
                      leaf_tol=_rwkv6_tol if arch == "rwkv6-7b" else None)


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_split_is_jax_spec_for_leaf(arch, runs):
    check_leaf_split(arch, runs()[0][(arch, "sync")][2])
    for T in ((4,) if arch == "rwkv6-7b" else (4, 8)):
        check_leaf_split(arch, None, T)


def test_w_zx_is_the_pair_of_its_blocks(runs):
    for r in range(2):
        pair, whole, norm = runs()[r]["pair"]
        assert pair and whole
        assert abs(norm - 1.0) <= 1e-6


def test_grid_with_mamba2_matches_one_process_and_resumes(tmp_path):
    check_grid(tmp_path, BASE + ["--arch", "zamba2-1.2b"])


def test_mamba2_heads_tensor_does_not_divide_are_refused():
    from repro_torch.configs import get_config
    cfg = get_config("zamba2-1.2b")
    assert rsh.tensor_refusal(cfg, 8) is None
    cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, head_dim=96))
    msg = rsh.tensor_refusal(cfg, 8)
    assert msg.startswith("unsupported combination: --tensor 8 with "
                          "zamba2-1.2b's 42 mamba2 heads — ") and \
        "; supported alternative: " in msg, msg
