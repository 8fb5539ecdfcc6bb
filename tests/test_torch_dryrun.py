"""The port's dry-run (``launch/dryrun.py``) against the JAX package's.

The pure functions (``model_flops``, ``min_bytes``, ``shape_applicable``,
and ``ideal_time`` under the port's H100 constants) equal JAX's exactly
for every ``list_archs()`` x ``SHAPES`` cell; the JAX side runs in a
subprocess, since importing ``repro.launch.dryrun`` sets a 512-device
XLA flag for its process.  The cells of JAX's ``tests/test_dryrun.py``
run here at full size on the meta device (seconds: nothing is
allocated) and are held to the same assertions, plus the kernels'
counted calls a step, which the stream tick fixes exactly.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import SHAPES, get_config, list_archs, \
    shape_applicable
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from test_torch_threads import one_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")

_JAX_SIDE = r"""
import json, sys
from repro.configs import SHAPES, get_config, list_archs, shape_applicable
from repro.launch import dryrun
peaks = json.loads(sys.argv[1])
out = {}
for arch in list_archs():
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        dryrun.HW = {"peak_flops": peaks[cfg.compute_dtype],
                     "hbm_bw": 3.35e12, "ici_bw": 450e9}
        out[f"{arch}/{name}"] = [
            dryrun.model_flops(cfg, shape), dryrun.min_bytes(cfg, shape),
            dryrun.min_bytes(cfg, shape, 1.5e9),
            list(shape_applicable(cfg, shape)),
            dryrun.ideal_time(cfg, shape, 1),
            dryrun.ideal_time(cfg, shape, 4, 2.5e8)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_side():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", _JAX_SIDE,
         json.dumps(dryrun.HW["peak_flops"])],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("arch", list_archs())
def test_pure_functions_equal_jax(arch, jax_side):
    cfg = get_config(arch)
    for name, shape in SHAPES.items():
        want = jax_side[f"{arch}/{name}"]
        got = [dryrun.model_flops(cfg, shape), dryrun.min_bytes(cfg, shape),
               dryrun.min_bytes(cfg, shape, 1.5e9),
               list(shape_applicable(cfg, shape)),
               dryrun.ideal_time(cfg, shape, 1),
               dryrun.ideal_time(cfg, shape, 4, 2.5e8)]
        assert got == want, (arch, name)


def test_hardware_is_one_h100():
    """No TPU constant: the peaks by compute dtype, HBM and NVLink."""
    assert dryrun.HW == {"peak_flops": {"bfloat16": 989e12,
                                        "float32": 67e12},
                         "hbm_bw": 3.35e12, "link_bw": 450e9,
                         "hbm_bytes": 80e9}


_CELLS = {}


def _cell(arch, shape, *extra):
    """One cell through the CLI, in process (once a module): its record,
    as ``--out`` appends it, and the launch counts it left."""
    key = (arch, shape) + extra
    if key not in _CELLS:
        import contextlib
        import io
        import tempfile
        ops.reset_launch_counts()
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "cells.jsonl")
            with contextlib.redirect_stdout(io.StringIO()):
                rc = dryrun.main(["--arch", arch, "--shape", shape,
                                  "--out", out, *extra])
            with open(out) as f:
                rec = json.loads(f.readline())
        assert rc == 0, rec
        _CELLS[key] = rec, dict(ops.launch_counts())
    return _CELLS[key]


@pytest.mark.parametrize("arch,shape", [
    ("granite-8b", "train_4k"),
    ("deepseek-moe-16b", "train_4k"),
    ("rwkv6-7b", "decode_32k"),
])
def test_full_size_cells_count(arch, shape):
    """JAX's ``test_smoke_cells_compile`` at full size on meta, with
    nothing launched."""
    rec, launched = _cell(arch, shape)
    assert rec["status"] == "ok", rec
    assert rec["cost"]["flops"] > 0
    assert rec["terms"]["compute_s"] > 0
    assert rec["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert all(n == 0 for n in launched.values())
    assert rec["logical_mesh"]["tensor"] == 1 and rec["chips"] == 1


def test_granite_train_cell_counts_every_kernel_and_does_not_fit():
    """granite-8b train_4k: 36 layers on its mesh plan's 4 stages, 8 ticks
    a step: 2L flash forwards (the forward and the backward's recompute),
    L of each backward kernel and S + 1 fused updates a tick; full depth
    does not fit one card (>= 16 B a parameter of fp32 state)."""
    rec, _ = _cell("granite-8b", "train_4k")
    cfg = get_config("granite-8b")
    L, S, T = cfg.n_layers, cfg.mesh_plan.pipe, rec["opts"]["ticks"]
    calls = {k: v["calls"] for k, v in rec["kernels"].items()}
    assert calls == {"flash_fwd": 2 * L * T, "flash_bwd_dq": L * T,
                     "flash_bwd_dkv": L * T, "fused_update": (S + 1) * T}
    assert rec["fits"] is False
    assert rec["memory"]["argument_bytes"] >= 16 * cfg.param_count()
    assert rec["memory"]["alias_bytes"] > 0       # the state, in place
    # counted matrix work above the useful 6 N T: the forward runs twice
    assert 0.5 < rec["useful_flops_ratio"] < 0.9


def test_sync_runtime_counts():
    rec, _ = _cell("granite-8b", "train_4k", "--runtime", "sync")
    assert rec["status"] == "ok", rec
    assert rec["kernels"]["fused_update"]["calls"] == 1


def test_skip_rule_applies():
    rec, _ = _cell("granite-8b", "long_500k")
    assert rec["status"] == "skip"
    assert "full-attention" in rec["skip_reason"]


def test_data_axis_reckons_the_all_reduce():
    """Under ``--data 2`` a replica holds ZeRO-1's momentum (the bytes of
    ``zero1_layout``, half the replicated momentum) and its step runs a
    reduce-scatter of the fp32 gradient and all-gathers (w and ŵ on the
    spectrain tick) instead of an all-reduce; ``fits`` follows from the
    counted bytes."""
    rec = dryrun.build_cell("granite-8b", "train_4k", smoke=True, data=2)
    grad = 4.0 * dryrun.param_elements(dryrun.Model(
        dryrun.cell_config("granite-8b", smoke=True), device="meta"))
    z = rec["data_axis"]
    assert z["momentum_bytes"] == z["zero1_bytes"] == grad / 2
    assert z["replicated_bytes"] == grad
    assert "all-reduce" not in rec["collectives"]
    rs, ag = (rec["collectives"][k] for k in ("reduce-scatter",
                                              "all-gather"))
    assert (rs["count"], ag["count"]) == (z["n_rs"], z["n_ag"])
    assert rs["result_bytes"] * 2 == z["bytes_rs"] == 2 * grad  # 2 ticks
    # w each tick, and ŵ (the stages' and the embedding's)
    assert ag["result_bytes"] == z["bytes_ag"]
    assert 2 * grad < z["bytes_ag"] < 2 * 2 * grad
    assert rec["wire_bytes_per_dev"] == rs["wire_bytes"] + ag["wire_bytes"]
    assert rec["chips"] == 2 and rec["terms"]["collective_s"] > 0
    one = dryrun.build_cell("granite-8b", "train_4k", smoke=True)
    assert one["memory"]["argument_bytes"] - rec["memory"][
        "argument_bytes"] >= grad / 2


class CounterProbe:
    """``on_step`` of a ``--data`` launcher run: rank 0 writes its data
    group's counters after the first step."""

    def __init__(self, path):
        self.path = path

    def __call__(self, s, state, metrics):
        from repro_torch.runtime import sharding as rsh
        g = rsh.current_group()
        if s == 0 and g.rank == 0:
            from repro_torch.models.layers import tree_leaves
            c = dict(g.data.counters())
            c["momentum_bytes"] = sum(
                t.numel() * t.element_size()
                for t in tree_leaves(state["momentum"]))
            with open(self.path, "w") as f:
                json.dump(c, f)


@pytest.mark.parametrize("runtime", ["stream", "sync"])
def test_data_axis_counts_the_launchers_zero1(runtime, tmp_path):
    """The dry-run's smoke cell at ``--data 2`` against a CPU
    ``launch.train --data 2`` step of the same cell: its reduce-scatters,
    all-gathers and small reductions, their bytes and the momentum a
    replica holds equal the launcher's ``StageGroup`` counters
    exactly."""
    from repro_torch.launch import train
    rec = dryrun.build_cell("granite-8b", "train_4k", smoke=True, data=2,
                            runtime=runtime)
    cfg = dryrun.cell_config("granite-8b", smoke=True)
    out = str(tmp_path / "c.json")
    argv = ["--arch", "granite-8b", "--smoke", "--device", "cpu",
            "--layers", "4", "--pipe", "2", "--ticks", "2", "--batch", "8",
            "--seq", "64", "--partitioner", "uniform", "--dtype",
            cfg.compute_dtype, "--data", "2", "--steps", "1",
            "--mode", "spectrain" if runtime == "stream" else "sync"]
    assert train.main(argv, on_step=CounterProbe(out)) == 0
    with open(out) as f:
        got = json.load(f)
    want = rec["data_axis"]
    for k in ("n_rs", "bytes_rs", "n_ag", "bytes_ag", "n_stat",
              "bytes_stat", "momentum_bytes"):
        assert got[k] == want[k], (k, got[k], want[k])
    assert got["n_reduce"] == 0


@pytest.mark.parametrize("flag,match", [
    (["--multipod"], "no pod"), (["--both-meshes"], "no pod"),
    (["--seq-shard"], "not sharded over tensor"),
    (["--no-ring-tp"], "not sharded over tensor"),
    (["--ssm-chunk", "64"], "chunked kernels")])
def test_mesh_flags_are_refused_in_three_parts(flag, match):
    with pytest.raises(SystemExit, match=match) as e:
        dryrun.main(["--arch", "granite-8b", "--shape", "train_4k", *flag])
    assert "unsupported combination" in str(e.value) and \
        "supported alternative" in str(e.value)


def test_smoke_cell_uses_no_device_memory():
    """A cell computes on meta only: the smoke cell of every family's
    train shape runs with no card and leaves every kernel unlaunched."""
    ops.reset_launch_counts()
    for arch in ("zamba2-1.2b", "minicpm3-4b", "whisper-base"):
        rec = dryrun.build_cell(arch, "train_4k", smoke=True)
        assert rec["status"] == "ok" and rec["cost"]["flops"] > 0
    assert all(n == 0 for n in ops.launch_counts().values())
    assert not torch.cuda.is_initialized()
