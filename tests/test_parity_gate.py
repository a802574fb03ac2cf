"""The bench parity gate actually gates.

``bench.py`` refuses to publish an RTF when ``production_parity`` fails;
this pins both halves end-to-end on the CPU backend (fused correlator in
interpret mode): the healthy production path passes the bounds, and the
deliberate code-index fault injection (``TrackingConfig.ablate_word_row``,
a kernel whose chips are misaligned) collapses the prompts and FAILS the
gate, which would make bench.py exit non-zero.

Runs in the default suite with the committed truth cache: the gate is the
bench's last line of defence and must never rot.
"""

import pytest

from tools.chip_parity import PARITY_BOUNDS, SETUP, production_parity


@pytest.fixture(scope="module")
def ns():
    n = {}
    exec(SETUP, n)
    return n


def test_healthy_production_path_passes(ns):
    res = production_parity(ns, interpret=True)
    assert res["parity_ok"], res
    assert res["parity_metric"] <= PARITY_BOUNDS["parity_metric"], res
    assert res["parity_scaled"] <= PARITY_BOUNDS["parity_scaled"], res
    lo, hi = PARITY_BOUNDS["prompt_ratio"]
    assert lo <= res["prompt_ratio"] <= hi, res


def test_ablated_lowering_fails(ns):
    res = production_parity(ns, ablate=True, interpret=True)
    assert not res["parity_ok"], (
        "code-index fault injection must fail the parity gate", res)
    # the signature of misaligned chips: prompt power collapses
    assert res["prompt_ratio"] < PARITY_BOUNDS["prompt_ratio"][0], res
