"""PipeDream-2BW through the port's IR interpreter against the JAX
package's, all three modes, and the double buffer's copy (see
``tests/test_torch_ir_train.py`` for the method and tolerances)."""
import pytest

from repro_torch.core import pipeline_stream as tps
from test_torch_ir_train import _check, _run, case_ids, check_round
from test_torch_threads import one_thread  # noqa: F401

CASES = [
    ("2bw", 2, 4, 1, "vanilla", 4, 2, None),
    ("2bw", 2, 5, 1, "pipedream", 4, 2, [1, 1, 1, 1, 3]),
    ("2bw", 3, 6, 1, "spectrain", 3, 3, None),
]


@pytest.mark.parametrize("case", CASES, ids=case_ids(CASES))
def test_round_matches_jax(case):
    check_round(case)


def test_2bw_stash_aliasing_the_updated_weights_fails(monkeypatch):
    """The in-place update writes the weights the stash must keep; a
    rotation that only re-references them (the JAX twin's
    ``{"params": params, ...}`` taken literally) would hand the next
    round the new weights.  Such a step departs from JAX at once."""
    case = ("2bw", 2, 4, 1, "spectrain", 4, 2, None)
    good = _run(case)
    js, jl = good["jax"]
    _check(js, jl, *good["scan"])

    def alias(state):
        state["stash"] = {"params": state["params"],
                          "momentum": state["momentum"]}

    monkeypatch.setattr(tps, "_stash_before_update", alias)
    ts, tl = _run(case, port_only=True)["scan"]
    assert ts["stash"]["params"] is ts["params"]
    with pytest.raises(AssertionError):
        _check(js, jl, ts, tl)
