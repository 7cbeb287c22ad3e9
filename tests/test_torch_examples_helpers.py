"""The study twins' copied numpy helpers against the `examples/` originals.

Each helper of `go_avalanche_tpu_torch/examples/` that the twin copies
from its JAX script (the fits, the churn models, the quorum closed
forms, the atlas's monotonicity report, the retire-cap law) takes the
same inputs as the original and must return the same value exactly
(tolerance 0: the same numpy code on the same numbers).  Plus the
twins' own plumbing: the default artifact paths and the card label.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

import examples.adversary_atlas as j_atlas
import examples.churn_tolerance as j_churn
import examples.finality_curves as j_fc
import examples.oppose_scaling as j_op
import examples.quorum_dial as j_qd
import examples.retire_cap_tradeoff as j_rc
from go_avalanche_tpu_torch.examples import _common
from go_avalanche_tpu_torch.examples import adversary_atlas as t_atlas
from go_avalanche_tpu_torch.examples import churn_tolerance as t_churn
from go_avalanche_tpu_torch.examples import finality_curves as t_fc
from go_avalanche_tpu_torch.examples import oppose_scaling as t_op
from go_avalanche_tpu_torch.examples import quorum_dial as t_qd
from go_avalanche_tpu_torch.examples import retire_cap_tradeoff as t_rc

REPO = Path(__file__).resolve().parents[1]


def _equal(a, b):
    """Exact equality of numbers, arrays and nested dicts / lists."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        return
    assert type(a) is type(b), (a, b)
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert a == b


def test_constants_match():
    for j, t, names in (
            (j_churn, t_churn, ("CHURN_GRID", "DROP_GRID", "CUTOFFS",
                                "VOTES_NEEDED", "BUMPS_NEEDED", "WINDOW",
                                "QUORUM")),
            (j_qd, t_qd, ("QUORUM_GRID", "EPS_GRID", "SAFETY_CELLS",
                          "WINDOW", "WINDOW_PAIRS")),
            (j_op, t_op, ("N_GRID",)),
            (j_rc, t_rc, ("NODES", "BACKLOG_SETS", "SET_CAP", "WINDOW_SETS",
                          "CAPS", "_SCORE_SEED", "_SIM_SEED", "MAX_ROUNDS")),
            (j_atlas, t_atlas, ("BYZ_GRID", "K_GRID", "QUORUM_GRID"))):
        for name in names:
            assert getattr(t, name) == getattr(j, name), name
    import examples.equivocation_threshold as j_eq
    from go_avalanche_tpu_torch.examples import equivocation_threshold as t_eq
    assert (t_eq.EPS_GRID, t_eq.P_GRID) == (j_eq.EPS_GRID, j_eq.P_GRID)


@pytest.mark.parametrize("c", [0.0, 0.003, 0.01, 0.1, 0.5])
def test_churn_models_match(c):
    for name in ("uptime_dp", "two_factor_dp", "window_dp"):
        _equal(getattr(t_churn, name)(c, 8, 40),
               getattr(j_churn, name)(c, 8, 40))
    for r in (0, 1, 7, 39):
        _equal(t_churn.alive_fraction(c, r), j_churn.alive_fraction(c, r))


@pytest.mark.parametrize("d", [0.0, 0.1, 0.3])
@pytest.mark.parametrize("k", [4, 8])
def test_drop_models_match(d, k):
    for name in ("drop_two_factor_dp", "drop_window_dp"):
        _equal(getattr(t_churn, name)(d, k, 30),
               getattr(j_churn, name)(d, k, 30))
    avail = lambda r: t_churn.alive_fraction(0.01, r) * (1 - d)  # noqa: E731
    _equal(t_churn._window_fp_dp(avail, 0.01, k, 30),
           j_churn._window_fp_dp(avail, 0.01, k, 30))


def test_median_round_matches():
    for done in (np.array([0.0, 0.2, 0.5, 1.0]), np.array([0.0, 0.1]),
                 t_churn.window_dp(0.01, 8, 30)):
        _equal(t_churn._median_round(done), j_churn._median_round(done))


@pytest.mark.parametrize("window", [4, 6, 8])
def test_quorum_closed_forms_match(window):
    for q in range(max(1, window - 3), window + 1):
        _equal(t_qd.a50(q, window), j_qd.a50(q, window))
        for a in (0.0, 0.5, 0.75, 0.9, 1.0):
            _equal(t_qd.c_q(a, q, window), j_qd.c_q(a, q, window))


def test_fits_match():
    rng = np.random.default_rng(0)
    ns = [128, 256, 512, 1024, 4096]
    for med in (10.0 + 2.5 * np.log2(ns), 0.01 * np.array(ns),
                rng.uniform(10, 40, len(ns)), np.full(len(ns), 17.0)):
        pts = [{"nodes": n, "median": float(m)} for n, m in zip(ns, med)]
        _equal(t_fc.fit_log_n(pts), j_fc.fit_log_n(pts))
    for eps in (3.0 * np.array(ns) ** -0.5, rng.uniform(0.01, 0.3, len(ns)),
                np.full(len(ns), 0.1)):
        pts = [{"n": n, "eps_star": float(e)} for n, e in zip(ns, eps)]
        _equal(t_op.fit_power_law(pts), j_op.fit_power_law(pts))


def _atlas_rows(rng, byz, ks, qs):
    rows = []
    for k in ks:
        for q in qs:
            for b in byz:
                lo = float(rng.uniform(0, 0.6))
                rows.append({"point": {"byzantine_fraction": b, "k": k,
                                       "quorum": q},
                             "p_stall": float(rng.uniform(0, 1)),
                             "stall_ci": [lo, lo + float(rng.uniform(0, 0.4))],
                             "p_violation": float(rng.uniform(0, 0.1))})
    return rows


def test_monotonicity_report_matches():
    rng = np.random.default_rng(1)
    for byz, ks, qs in ((j_atlas.BYZ_GRID, j_atlas.K_GRID,
                         j_atlas.QUORUM_GRID), ((0.05, 0.25, 0.45), (8,),
                                                (7,))):
        rows = _atlas_rows(rng, byz, ks, qs)
        _equal(t_atlas.monotonicity_report(rows, byz, ks, qs),
               j_atlas.monotonicity_report(rows, byz, ks, qs))


def test_retire_cap_law_matches():
    cells = [{"cap": None, "rounds_to_drain": 544,
              "settle_latency_median": 17.0, "settle_latency_p90": 17.0}]
    cells += [{"cap": c, "rounds_to_drain": r} for c, r in
              ((64, 544), (4, 559), (3, 699), (2, 1040), (1, 2064))]
    _equal(t_rc.law(cells), j_rc.law(cells))


def test_default_artifacts_leave_examples_out_alone():
    out = Path(_common.out_path("quorum_dial.json"))
    assert out.parent == REPO / "go_avalanche_tpu_torch" / "examples" / "out"
    assert REPO / "examples" not in out.parents
    assert _common.card("cpu") is None and _common.card_note(None) == ""
