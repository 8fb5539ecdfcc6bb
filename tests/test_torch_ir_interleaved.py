"""Interleaved 1F1B (v = 2 virtual stages, S·v chunk trees) through the
port's IR interpreter against the JAX package's (see
``tests/test_torch_ir_train.py`` for the method and tolerances)."""
import pytest

from test_torch_ir_train import case_ids, check_round
from test_torch_threads import one_thread  # noqa: F401

CASES = [
    ("interleaved", 2, 4, 2, "spectrain", 4, 2, None),
    ("interleaved", 2, 5, 2, "pipedream", 4, 2, [2, 1, 1, 1, 1]),
    ("interleaved", 3, 6, 2, "vanilla", 3, 3, None),
]


@pytest.mark.parametrize("case", CASES, ids=case_ids(CASES))
def test_round_matches_jax(case):
    check_round(case)
