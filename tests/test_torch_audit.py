"""The port's contract audit (`go_avalanche_tpu_torch/analysis/audit.py`).

The JAX audit reads lowered programs and cannot be the oracle here (its
own pin, sharded and donation audits fail against this container's jax),
so the port's audit is held, as `tests/test_analysis.py` holds the
reference's, to planted violations — one for each contract: a tap row
and a host read in an off-path program, a host read outside `sync.py`,
host data copied to the device, a float64 output, an int64 plane outside
`prng`, a second kernel launch over budget and an undeclared kernel, a
collective in a single-device program, an undeclared collective, a
plane-sized all-gather, a stale manifest entry, and a leaf that is a view
of a larger temporary — and to its tables being the reference's.  Every
program of the table is clean at its audit shape on the CPU, and the
five sharded drivers and the sharded fleet are clean on one 2x2 pool of
gloo ranks.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from go_avalanche_tpu_torch import prng, sync, workload
from go_avalanche_tpu_torch.analysis import audit
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.parallel import collectives as C
from go_avalanche_tpu_torch.parallel.mesh import NODES_AXIS, make_mesh
from go_avalanche_tpu_torch.parallel.ranks import RankPool
import torch_ranks


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    ranks = RankPool(4, str(tmp_path_factory.mktemp("ranks")))
    yield ranks
    ranks.close()


# ------------------------------------------------------- the tables


def test_tables_are_the_references():
    from benchmarks import hlo_pin
    from go_avalanche_tpu.analysis import hlo_audit

    assert audit.PROGRAMS == {name: w for name, (w, _) in
                              hlo_pin.PROGRAMS.items()}
    for name in audit.PROGRAMS:
        assert audit.small_workload(name) == hlo_audit.small_workload(name)
    assert audit.PINNED_CALLBACK_BUDGET == hlo_audit.PINNED_CALLBACK_BUDGET
    assert audit.PINNED_UNDONATED == hlo_audit.PINNED_UNDONATED
    assert audit.SHARDED_DRIVERS == hlo_audit.SHARDED_DRIVERS
    assert audit._ASYNC_KW == hlo_audit._ASYNC_KW
    # one kernel a round where the reference allows one Pallas program
    for name, budget in hlo_audit.PINNED_KERNEL_BUDGET.items():
        program = audit.pinned_program(name, device="cpu")
        assert sum(program.kernels.values()) == sum(budget.values())
        assert program.kernels == audit.PINNED_KERNEL_BUDGET[name]


KERNEL_BUDGETS = {   # name -> (config knobs, dag round, budget a round)
    "phased": (dict(), False, {"vote_u8": 1, "vote_packs": 1}),
    "swar32": (dict(ingest_engine="swar32"), False,
               {"vote_swar": 1, "vote_packs": 1}),
    "dag": (dict(), True, {"vote_u8": 1, "vote_packs": 1, "prefs_pack": 1}),
    "megakernel": (dict(round_engine="megakernel"), False, {"megakernel": 1}),
    "oppose": (dict(byzantine_fraction=0.2,
                    adversary_strategy="oppose_majority"), True,
               {"vote_u8": 1, "vote_packs": 1, "prefs_pack": 1}),
    "equivocate": (dict(byzantine_fraction=0.2,
                        adversary_strategy="equivocate"), True,
                   {"vote_u8": 1, "prefs_pack": 1}),
    "split_vote": (dict(byzantine_fraction=0.2,
                        adversary_policy="split_vote"), True, {"vote_u8": 1}),
    "legacy": (dict(fused_exchange=False), False, {"vote_u8": 1}),
    "async_walk": (dict(audit._ASYNC_KW), True,
                   {"vote_packs": 5, "prefs_pack": 1}),
    "async_coalesced": (dict(audit._ASYNC_KW, inflight_engine="coalesced"),
                        False, {}),
}


@pytest.mark.parametrize("name", sorted(KERNEL_BUDGETS))
def test_round_kernels_budget_the_exchange_kernels(name):
    """The exchange kernels' launches a round where `ops/exchange` routes
    to them on the card: one `vote_packs` an exchange (the walk ring's
    five ages under a 3 s timeout at 1 s steps), one `prefs_pack` a DAG
    round; none under EQUIVOCATE, split_vote, the legacy engine, the
    coalesced ring or the megakernel."""
    from go_avalanche_tpu_torch.config import AdversaryStrategy, AvalancheConfig

    knobs, dag, budget = KERNEL_BUDGETS[name]
    if "adversary_strategy" in knobs:
        knobs = dict(knobs, adversary_strategy=AdversaryStrategy(
            knobs["adversary_strategy"]))
    cfg = AvalancheConfig(**knobs)
    assert audit.round_kernels(cfg, dag=dag) == budget
    assert audit.round_kernels(cfg, 3, dag=dag) == {
        k: 3 * v for k, v in budget.items()}


@pytest.mark.parametrize("name", sorted(audit.PROGRAMS))
def test_every_program_is_clean_at_its_audit_shape(name):
    assert audit.audit_program(name, device="cpu") == []


# ------------------------------------------------- planted violations


def _flagship():
    state, cfg = workload.flagship_state(32, 32, device="cpu")
    return state, cfg


def _program(step, **kw):
    state, cfg = _flagship()
    kw.setdefault("plane_elems", 32 * 32)
    return audit.Program(what="planted", step=step, state=state, **kw)


def _round(cfg):
    return lambda s: av.round_step(s, cfg)[0]


def _fails(program):
    return audit.audit(program)[0]


def test_the_unplanted_round_is_clean():
    _, cfg = _flagship()
    assert _fails(_program(_round(cfg), kernels=audit.round_kernels(cfg))) \
        == []


def test_a_tap_in_an_off_path_program_fails():
    from go_avalanche_tpu_torch.obs import sink

    _, cfg = _flagship()
    tapped = dataclasses.replace(cfg, metrics_every=1)

    def step(s):
        new, tel = av.round_step(s, cfg)
        sink.emit_round(tapped, new.round, tel)
        return new

    fails = _fails(_program(step, kernels=audit.round_kernels(cfg)))
    assert len(fails) == 1 and "1 metrics-tap row(s)" in fails[0]
    assert _fails(_program(step, callbacks=1,
                           kernels=audit.round_kernels(cfg))) == []


def test_a_host_read_in_an_off_path_program_fails():
    _, cfg = _flagship()

    def step(s):
        new = av.round_step(s, cfg)[0]
        sync.read(new.round)
        return new

    fails = _fails(_program(step, kernels=audit.round_kernels(cfg)))
    assert len(fails) == 1 and "1 counted host read(s)" in fails[0]


def test_a_read_outside_sync_py_fails():
    _, cfg = _flagship()

    def step(s):
        new = av.round_step(s, cfg)[0]
        int(new.round)
        return new

    fails = _fails(_program(step, kernels=audit.round_kernels(cfg)))
    assert len(fails) == 1 and "aten._local_scalar_dense" in fails[0]
    assert "outside sync.py" in fails[0]


def test_host_data_copied_to_the_device_fails():
    _, cfg = _flagship()

    def step(s):
        new = av.round_step(s, cfg)[0]
        zero = torch.tensor(0, dtype=torch.int32)
        return new._replace(round=new.round + zero)

    fails = _fails(_program(step, kernels=audit.round_kernels(cfg)))
    assert len(fails) == 1 and "host data copied" in fails[0]
    assert "torch.tensor at test_torch_audit.py" in fails[0]

    def assigned(s):
        new = av.round_step(s, cfg)[0]
        added = new.added.clone()
        added[0] = False                  # a host value into the plane
        return new._replace(added=added)

    fails = _fails(_program(assigned, kernels=audit.round_kernels(cfg)))
    assert len(fails) == 1 and "a host value assigned into a tensor at " \
        "test_torch_audit.py" in fails[0]


def test_a_float64_output_fails():
    _, cfg = _flagship()

    def step(s):
        new = av.round_step(s, cfg)[0]
        new.latency_weight.double().sum()
        return new

    fails = _fails(_program(step, kernels=audit.round_kernels(cfg)))
    assert [f.split(" output")[0] for f in fails] == [
        "planted: 1 aten._to_copy", "planted: 1 aten.sum"]
    assert all("of float64 — the dtype budget" in f for f in fails)


def test_an_int64_plane_outside_prng_fails_and_prng_and_indices_pass():
    _, cfg = _flagship()

    def planted(s):
        new = av.round_step(s, cfg)[0]
        new.records.votes.long() + 1
        return new

    fails = _fails(_program(planted, kernels=audit.round_kernels(cfg)))
    assert len(fails) == 2
    assert all("int64 of 1024 elements" in f for f in fails)

    def allowed(s):
        new = av.round_step(s, cfg)[0]
        prng.uniform(new.key, (32, 32))        # int64 words, float64 FMA
        flat = torch.zeros(32 * 32, dtype=torch.int32)
        flat[torch.arange(32 * 32).long()]     # an int64 index plane
        return new

    assert _fails(_program(allowed, kernels=audit.round_kernels(cfg))) == []


def test_a_second_kernel_launch_over_budget_fails(monkeypatch):
    from go_avalanche_tpu_torch.ops import megakernel, pallas_vote

    _, cfg = _flagship()
    monkeypatch.setitem(pallas_vote.launches, "vote_u8", 0)
    monkeypatch.setattr(megakernel, "launches", 0)

    def twice(s):
        pallas_vote.launches["vote_u8"] += 2
        return av.round_step(s, cfg)[0]

    fails = _fails(_program(twice, kernels={"vote_u8": 1}))
    assert len(fails) == 1 and "2 vote_u8 launch(es)" in fails[0]

    def undeclared(s):
        megakernel.launches += 1
        return av.round_step(s, cfg)[0]

    fails = _fails(_program(undeclared, kernels={"vote_u8": 1}))
    assert len(fails) == 1 and "undeclared kernel megakernel" in fails[0]


def _collective(kind, plane=False):
    _, cfg = _flagship()
    mesh = make_mesh(1, 1)

    def step(s):
        new = av.round_step(s, cfg)[0]
        with C.bind(mesh):
            if kind == "all_gather":
                C.all_gather(new.records.votes if plane else new.round[None],
                             NODES_AXIS)
            else:
                C.psum(new.round[None], NODES_AXIS)
        return new

    return mesh, step, audit.round_kernels(cfg)


def test_a_collective_in_a_single_device_program_fails():
    _, step, kernels = _collective("all_reduce")
    fails = _fails(_program(step, kernels=kernels))
    assert len(fails) == 1 and "single-device program calls collectives" \
        in fails[0]


def test_an_undeclared_collective_fails():
    mesh, step, kernels = _collective("all_reduce")
    declared = frozenset({("all_gather", (NODES_AXIS,))})
    fails = _fails(_program(step, kernels=kernels, mesh=mesh,
                            collectives=declared))
    assert len(fails) == 1
    assert "UNDECLARED collective all_reduce over axes nodes" in fails[0]


def test_a_plane_sized_all_gather_fails():
    mesh, step, kernels = _collective("all_gather", plane=True)
    declared = frozenset({("all_gather", (NODES_AXIS,))})
    fails = _fails(_program(step, kernels=kernels, mesh=mesh,
                            collectives=declared))
    assert len(fails) == 1 and "all_gather over nodes of 1024 elements" \
        in fails[0]
    mesh, small, kernels = _collective("all_gather")
    assert _fails(_program(small, kernels=kernels, mesh=mesh,
                           collectives=declared)) == []


def test_a_leaf_viewing_a_larger_temporary_fails():
    _, cfg = _flagship()

    def step(s):
        new = av.round_step(s, cfg)[0]
        big = torch.zeros((4 * 32, 32), dtype=torch.int32)
        big[:32] = new.finalized_at
        return new._replace(finalized_at=big[:32])

    fails = _fails(_program(step, kernels=audit.round_kernels(cfg)))
    assert len(fails) == 1 and "a view into a larger temporary" in fails[0]
    # an in-place program that returns new storages fails too
    fails = _fails(_program(_round(cfg), kernels=audit.round_kernels(cfg),
                            in_place=True))
    assert len(fails) == 1 and "not updated in place" in fails[0]


def test_sharded_audits_refuse_without_four_ranks():
    with pytest.raises(audit.AuditUnavailable, match="needs 4 ranks"):
        audit.audit_sharded("avalanche", "cpu")
    with pytest.raises(audit.AuditUnavailable, match="needs 4 ranks"):
        audit.audit_sharded_fleet("cpu")


# ------------------------------------------------ sharded, on 4 ranks


@pytest.mark.parametrize("driver", audit.SHARDED_DRIVERS)
def test_sharded_driver_is_clean(pool, driver):
    for failures in pool.run(4, torch_ranks.audit_driver_case, driver):
        assert failures == []


def test_sharded_fleet_is_clean(pool):
    for failures in pool.run(4, torch_ranks.audit_fleet_case):
        assert failures == []


def test_a_stale_manifest_entry_fails(pool):
    for failures in pool.run(4, torch_ranks.audit_driver_case, "backlog",
                             ("all_to_all", ("txs",))):
        assert failures == [
            "sharded:backlog: declared collective all_to_all over axes "
            "txs never called in any audit variant — stale manifest "
            "entry"]
