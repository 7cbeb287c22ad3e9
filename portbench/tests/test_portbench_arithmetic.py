"""The benchmark's own arithmetic: vote counts, percentiles, the
roofline's bytes, the trace reduction's interval algebra."""

import numpy as np
import pytest
import torch

from portbench import roofline, stats, tracing
from portbench.drivers import dag_settle
from portbench.end_to_end import round_ms_p95, votes_per_s
from portbench.harness import Outcome
from portbench.layer_metrics import idle_share, ingest_roofline


H100 = "NVIDIA H100 80GB HBM3"


def _outcome(**kw):
    base = dict(setup_s=1.0, window_s=2.0, round_s=[], counters={},
                attempted=0, failed=0, memory_peak_bytes=0, checks={})
    base.update(kw)
    return Outcome(**base)


def test_portbench_votes_do_not_wrap_int32():
    # 17 rounds at 16384^2 with every record polled: the program's int32
    # polls fit, k x polls does not (int32 would wrap at 2**31).
    polls_i32 = torch.tensor(16384 * 16384, dtype=torch.int32)
    assert (polls_i32 * 8).item() < 0
    flag = torch.tensor(False)
    polls = [dag_settle.read_round(flag, polls_i32)[1] for _ in range(17)]
    votes = 8 * sum(polls)
    assert votes == 8 * 17 * 16384 ** 2 > 2 ** 31
    assert votes_per_s.read(_outcome(counters={"votes": votes},
                                     window_s=2.0)) == votes / 2.0


def test_portbench_p95_over_every_round():
    rounds = [0.030] * 190 + [0.050] * 10
    value = round_ms_p95.read(_outcome(round_s=rounds))
    assert value == pytest.approx(stats.percentile(rounds, 95) * 1e3)
    assert 30.0 <= value <= 50.0
    assert stats.percentile(list(range(101)), 95) == pytest.approx(95.0)


def test_portbench_ingest_bound_at_16384_squared():
    records = 16384 * 16384
    bound = roofline.ingest_bound_s(records, records, 16384, H100)
    assert bound * 1e3 == pytest.approx(0.8815, abs=5e-4)
    assert roofline.ingest_bytes(records, records, 16384) == (
        11 * records + 16384)


def test_portbench_ingest_bytes_pass_unpolled_records_through():
    records = 16384 * 16384
    # Half polled: 11 B a polled record, 10 B a record passed through.
    assert roofline.ingest_bytes(records // 2, records, 16384) == (
        11 * records // 2 + 10 * records // 2 + 16384)
    # None polled: the launch still reads and writes every record.
    assert roofline.ingest_bound_s(0, records, 16384, H100) == pytest.approx(
        (10 * records + 16384) / 3.35e12)
    with pytest.raises(ValueError):
        roofline.ingest_bytes(records + 1, records, 16384)


def test_portbench_ingest_roofline_reader():
    sl = tracing.TraceSlice(rounds=2, polls=[100_000_000, 50_000_000],
                            nodes=10_000, records=100_000_000, card=H100,
                            window_s=1.0)
    assert ingest_roofline.read(sl) is None          # nothing measured
    bound_s = sum(roofline.ingest_bound_s(p, sl.records, 10_000, sl.card)
                  for p in sl.polls)
    sl.kernel_ms = {"vote_u8_kernel": 2 * bound_s * 1e3}
    sl.kernel_launches = {"vote_u8_kernel": 2}
    assert ingest_roofline.read(sl) == pytest.approx(50.0)
    sl.kernel_launches = {"vote_u8_kernel": 3}       # a launch not counted
    assert ingest_roofline.read(sl) is None
    sl.kernel_launches = {"vote_u8_kernel": 2}
    sl.card = "a card without a published peak"
    assert ingest_roofline.read(sl) is None


def test_portbench_drivers_read_the_ingest_kernels_of_the_roofline():
    import inspect
    from portbench.drivers import stream_steady
    for module in (dag_settle, stream_steady, ingest_roofline):
        assert "roofline.INGEST_KERNELS" in inspect.getsource(module)
        assert not hasattr(module, "KERNELS")


def test_portbench_union_and_gaps():
    iv = np.array([[0.0, 10.0], [5.0, 20.0], [30.0, 40.0], [50.0, 55.0]])
    busy, merged = tracing.union_seconds(iv)
    assert busy == pytest.approx(35e-6)
    assert merged.tolist() == [[0.0, 20.0], [30.0, 40.0], [50.0, 55.0]]
    gaps = tracing.gaps_by_span(merged, [("outer", 0.0, 60.0),
                                         ("inner", 22.0, 28.0)])
    assert dict(gaps) == pytest.approx({"inner": 10e-6, "outer": 10e-6})
    sl = tracing.TraceSlice(rounds=1, polls=[1], nodes=1, card="",
                            window_s=3.0, busy_s=1.5)
    assert idle_share.read(sl) is None               # no untraced stretch
    sl.pace_s = 2.0       # the same work untraced, not the traced window
    assert idle_share.read(sl) == pytest.approx(25.0)
    sl.pace_s = 1.0       # more device time than wall time: no reading
    assert idle_share.read(sl) is None
