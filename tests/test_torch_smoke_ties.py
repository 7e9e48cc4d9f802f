"""The tie rule of `chip_smoke.py:compare_runs`, which judges two serving
runs' tokens equal up to argmax ties on the card: where a request's
tokens first differ, one run's top two logits must tie within TIE_GAP,
or, on bf16 logits, the two runs' top two must be the same two tokens in
swapped order, each pair at most one bf16 step apart."""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as C  # noqa: E402


def _run(second_token, top2, idx):
    """One request of two tokens; the second is judged."""
    return {"tokens": {0: [1, second_token]},
            "top2": {0: np.array([[6.0, 5.0], top2], np.float32)},
            "top2_idx": {0: np.array([[1, 2], idx])}}


# (run a's second token, top-2, indices; run b's; bf16 logits; a tie?)
CASES = {
    # one run's logits tie exactly: its choice was arbitrary
    "exact_tie": ((5, [5.0, 5.0], [5, 7]), (7, [5.0625, 5.0], [7, 5]),
                  True, True),
    "exact_tie_f32": ((5, [5.0, 5.0], [5, 7]), (7, [5.0001, 5.0], [7, 3]),
                      False, True),
    # the same two tokens, swapped, each one bf16 step (2^-5 at 5.0) apart
    "swapped_one_step": ((5, [5.03125, 5.0], [5, 7]),
                         (7, [5.03125, 5.0], [7, 5]), True, True),
    "swapped_one_step_f32": ((5, [5.03125, 5.0], [5, 7]),
                             (7, [5.03125, 5.0], [7, 5]), False, False),
    "swapped_two_steps": ((5, [5.0625, 5.0], [5, 7]),
                          (7, [5.0625, 5.0], [7, 5]), True, False),
    "one_step_not_swapped": ((5, [5.03125, 5.0], [5, 7]),
                             (9, [5.03125, 5.0], [9, 8]), True, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_runs_tie_rule(case):
    a, b, bf16, tie = CASES[case]
    ra, rb = _run(*a), _run(*b)
    if tie:
        out = C.compare_runs(case, ra, rb, bf16)
        assert out["identical"] == 0 and out["ties"][0]["at"] == 1
    else:
        with pytest.raises(RuntimeError, match="diverges at token 1"):
            C.compare_runs(case, ra, rb, bf16)


def test_compare_runs_counts_identical_requests():
    ra = _run(5, [5.5, 5.0], [5, 7])
    assert C.compare_runs("same", ra, ra, True) == {
        "requests": 1, "identical": 1, "ties": []}


@pytest.mark.parametrize("x, step", [(5.0, 2.0 ** -5), (-9.0, 2.0 ** -4),
                                     (0.75, 2.0 ** -8), (0.0, 0.0)])
def test_bf16_step_is_the_spacing_of_bf16_values(x, step):
    """|x| + step is the next bf16 value above |x| (for |x| on a power
    of two or inside its binade): representable, while a quarter step
    rounds back to |x|."""
    import torch
    assert C.bf16_step(x) == step
    if x:
        def bf16(v):
            return float(torch.tensor(v).to(torch.bfloat16).float())
        assert bf16(abs(x) + step) == abs(x) + step
        assert bf16(abs(x) + step / 4) == abs(x)
