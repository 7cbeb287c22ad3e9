"""The comparison fails where it must: the control (the reference with
the sequential-vote guarantee broken, in the program's place) and the
timed path broken underneath, each through a whole run past the look
for a card."""

import pytest
import torch

from portbench import control
from portbench.tests.conftest import TINY, run_tiny


@pytest.mark.parametrize("cell", sorted(TINY))
def test_portbench_control_is_not_correct(cell):
    program = control.control_program(cell, torch.device("cpu"), TINY[cell])
    line = run_tiny(cell, program=program)
    assert not line["correct"]


def _unchanged_round(monkeypatch):
    from go_avalanche_tpu_torch.models import dag
    real = dag.round_step

    def step(state, cfg=dag.DEFAULT_CONFIG):
        return state, real(state, cfg)[1]
    monkeypatch.setattr(dag, "round_step", step)


def _unchanged_stream_step(monkeypatch):
    from go_avalanche_tpu_torch.models import streaming_dag
    real = streaming_dag.step

    def step(state, cfg=streaming_dag.DEFAULT_CONFIG):
        return state, real(state, cfg)[1]
    monkeypatch.setattr(streaming_dag, "step", step)


def _half_batch(monkeypatch):
    from go_avalanche_tpu_torch.ops import pallas_vote
    real = pallas_vote.register_packed_votes_fused

    def ingest(state, yes_pack, consider_pack, k, cfg, update_mask=None):
        new, changed = real(state, yes_pack, consider_pack, k, cfg,
                            update_mask)
        half = state.votes.shape[0] // 2
        kept = type(new)(*(torch.cat([n[:half], o[half:]])
                           for n, o in zip(new, state)))
        return kept, changed
    monkeypatch.setattr(pallas_vote, "register_packed_votes_fused", ingest)


def _altered_answer(monkeypatch):
    from go_avalanche_tpu_torch.ops import pallas_vote
    real = pallas_vote.register_packed_votes_fused

    def ingest(state, yes_pack, consider_pack, k, cfg, update_mask=None):
        new, changed = real(state, yes_pack, consider_pack, k, cfg,
                            update_mask)
        conf = new.confidence.clone()
        conf[0, 0] ^= 2            # one vote record's counter, one step
        return new._replace(confidence=conf), changed
    monkeypatch.setattr(pallas_vote, "register_packed_votes_fused", ingest)


def _altered_outcome(monkeypatch):
    from go_avalanche_tpu_torch.models import streaming_dag
    real = streaming_dag._retire_and_refill

    def retire(state, cfg, refill=True):
        new, retired = real(state, cfg, refill)
        accepted = new.outputs.accepted.clone()
        accepted[0, 1] = ~accepted[0, 1]   # the first set's loser wins too
        return new._replace(outputs=new.outputs._replace(
            accepted=accepted)), retired
    monkeypatch.setattr(streaming_dag, "_retire_and_refill", retire)


FAULTS = {
    "dag10k-settle": {"state_unchanged": _unchanged_round,
                      "half_batch": _half_batch,
                      "altered_answer": _altered_answer},
    "stream100k-saturated": {"state_unchanged": _unchanged_stream_step,
                             "half_batch": _half_batch,
                             "altered_answer": _altered_answer,
                             "altered_outcome": _altered_outcome},
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS)
                                        for f in FAULTS[c]])
def test_portbench_broken_timed_path_is_not_correct(cell, fault,
                                                    monkeypatch):
    FAULTS[cell][fault](monkeypatch)
    line = run_tiny(cell)
    assert not line["correct"], line["checks"]


def _late(monkeypatch, alter, after: int = 90):
    """Break the streaming step from its `after`-th call on, past the
    steps the reference replays (set-up and at most three segments)."""
    from go_avalanche_tpu_torch.models import streaming_dag
    real = streaming_dag.step
    calls = [0]

    def step(state, cfg=streaming_dag.DEFAULT_CONFIG):
        calls[0] += 1
        new, tel = real(state, cfg)
        if calls[0] == after:
            new = alter(state, new)
        return new, tel
    monkeypatch.setattr(streaming_dag, "step", step)


def _key_held(old, new):
    base = new.dag.base._replace(key=old.dag.base.key)
    return new._replace(dag=new.dag._replace(base=base))


def _set_skipped(old, new):
    return new._replace(next_idx=new.next_idx + 1)


def _retirement_lost(old, new):
    settled = new.outputs.settled.clone()
    row = int(settled.any(dim=1).nonzero()[0])
    settled[row] = False
    return new._replace(outputs=new.outputs._replace(settled=settled))


def _backlog_written(old, new):
    score = new.backlog.score.clone()
    score[-1, 0] += 1
    return new._replace(backlog=new.backlog._replace(score=score))


LATE = {"key_held": _key_held, "set_skipped": _set_skipped,
        "retirement_lost": _retirement_lost,
        "backlog_written": _backlog_written}


@pytest.mark.parametrize("fault", sorted(LATE))
def test_portbench_stream_fault_past_the_replay_is_not_correct(fault,
                                                               monkeypatch):
    _late(monkeypatch, LATE[fault])
    line = run_tiny("stream100k-saturated", seconds=1.5)
    replayed = line["notes"]["checked_segment"] * 17
    assert line["samples"]["rounds"] > replayed + 40
    assert not line["correct"], line["checks"]
