"""The streaming scheduler's window kernels (`ops/scheduler.py`,
`csrc/scheduler.cu`) and their routes.

On the CPU: the routes are a rule of the device and the set size, CPU
tensors keep the plain path, a step routed as on the card (the kernels'
plain versions standing in for them) equals a plain step leaf for leaf,
the sparse retire cap keeps its column rewrite, and the wrappers refuse
what the kernels do not take before any launch.  On the card (marked
`cuda`, skipped elsewhere): each kernel against its plain version on
random windows, and a short stream run through the kernels against the
same run on the CPU.  Imports neither JAX nor the JAX package, so it runs
on a GPU machine without them:

    python -m pytest tests/test_torch_scheduler.py -m cuda

Tolerance 0: every plane compared bit for bit.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from go_avalanche_tpu_torch import prng
from go_avalanche_tpu_torch.config import AvalancheConfig
from go_avalanche_tpu_torch.models import avalanche as av
from go_avalanche_tpu_torch.models import streaming_dag as sdg
from go_avalanche_tpu_torch.ops import scheduler
from go_avalanche_tpu_torch.ops import voterecord as vr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def random_window(seed: int, n: int, w: int, c: int, score: int,
                  device="cpu") -> dict:
    """A window of `w // c` sets of `c` lanes over `n` nodes, drawn so
    that each kind of set occurs: untouched records, sets that some
    member finalized accepted at every node (its rivals settled, or the
    member rejected: a rival finalized), sets wholly finalized, invalid
    sets, dead nodes, records no longer added, and counters saturated at
    0x7FFF (negative as int16)."""
    rng = np.random.default_rng(seed)
    s_w = w // c
    counter = np.where(rng.random((n, w)) < 0.5,
                       rng.integers(0, 0x8000, (n, w)),
                       score + rng.integers(-3, 4, (n, w)))
    counter[rng.random((n, w)) < 0.1] = 0x7FFF
    kind = rng.integers(0, 5, s_w)
    cols = np.arange(w).reshape(s_w, c)
    for s in np.flatnonzero(kind == 1):       # one member finalized, a node
        lane = cols[s, rng.integers(0, c, n)]
        counter[np.arange(n), lane] = np.maximum(
            counter[np.arange(n), lane], score)
    for s in np.flatnonzero(kind == 2):       # every member finalized
        counter[:, cols[s]] = np.maximum(counter[:, cols[s]], score)
    counter = np.clip(counter, 0, 0x7FFF)
    conf = ((counter << 1) | rng.integers(0, 2, (n, w))).astype(np.uint16)
    for s in np.flatnonzero(kind == 1):       # ... and accepted it
        lane = cols[s, 0]
        conf[:, lane] |= 1
    valid = rng.random(w) < 0.9
    valid[cols[kind == 3].reshape(-1)] = False
    added = rng.random((n, w)) < 0.9
    added[:, rng.random(w) < 0.05] = False
    alive = rng.random(n) < 0.9

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return dict(confidence=t_(conf.view(np.int16)), added=t_(added),
                alive=t_(alive), valid=t_(valid))


def random_planes(seed: int, n: int, w: int, tracked: bool,
                  device="cpu") -> tuple:
    """A refill's inputs: ``(records, added, finalized_at, take_w,
    occupied_after_w, fresh_pref)``, with whole sets of 2 taken or freed
    and `finalized_at` None unless `tracked`."""
    rng = np.random.default_rng(seed)

    def t_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def by_set(p):
        return np.repeat(rng.random(-(-w // 2)) < p, 2)[:w]

    records = vr.VoteRecordState(
        t_(rng.integers(0, 256, (n, w), dtype=np.uint8)),
        t_(rng.integers(0, 256, (n, w), dtype=np.uint8)),
        t_(rng.integers(0, 0x10000, (n, w)).astype(np.uint16)
           .view(np.int16)))
    take = by_set(0.3)
    finalized_at = (t_(rng.integers(-1, 500, (n, w)).astype(np.int32))
                    if tracked else None)
    return (records, t_(rng.random((n, w)) < 0.8), finalized_at, t_(take),
            t_(take | by_set(0.6)), t_(rng.random(w) < 0.5))


def old_settle_composition(confidence, added, alive, valid, c, cfg):
    """The scheduler's settle test as it was written before the scan
    (a rival of a set finalized accepted at a node is settled there)."""
    n, w = confidence.shape
    fin = vr.has_finalized(confidence, cfg)
    fin_acc = fin & vr.is_accepted(confidence)
    node_set_done = fin_acc.reshape(n, w // c, c).any(dim=2)
    rival_settled = node_set_done.repeat_interleave(c, dim=1) & ~fin_acc
    pending = (added & alive[:, None] & valid[None, :] & ~fin
               & ~rival_settled)
    return (pending.reshape(n, w // c, c).any(dim=2).any(dim=0),
            (fin_acc & added).sum(dim=0, dtype=torch.int32))


def assert_equal_trees(want, got, where: str) -> None:
    """Every tensor leaf equal, dtype and device type included; ints and
    None equal."""
    if isinstance(got, torch.Tensor):
        assert isinstance(want, torch.Tensor), where
        assert got.dtype == want.dtype, (where, want.dtype, got.dtype)
        assert torch.equal(got.cpu(), want.cpu()), where
    elif isinstance(got, tuple):
        assert len(got) == len(want), where
        names = getattr(got, "_fields", range(len(got)))
        for name, g, w in zip(names, got, want):
            assert_equal_trees(w, g, f"{where}.{name}")
    else:
        assert got == want, (where, want, got)


def stream_state(c: int = 2, n: int = 24, window_sets: int = 5,
                 n_sets: int = 30, track_finality: bool = True,
                 device="cpu", **knobs):
    cfg = AvalancheConfig(finalization_score=12, **knobs)
    scores = torch.from_numpy(np.random.default_rng(c).integers(
        0, 1000, (n_sets, c)).astype(np.int32))
    backlog = sdg.make_set_backlog(scores)
    return sdg.init(prng.key(3, device), n, window_sets, backlog, cfg,
                    track_finality=track_finality, device=device), cfg


# ------------------------------------------------------- routes, CPU side


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_routes_are_a_rule_of_device_and_set_size(device):
    dev = torch.device(device)
    for c in range(1, 10):
        assert scheduler.settle_scan_route(dev, c) == (
            device == "cuda" and c in (1, 2, 4, 8))
    assert scheduler.refill_route(dev) == (device == "cuda")


@pytest.mark.parametrize("c,w", [(1, 24), (2, 2048), (2, 1998), (3, 51),
                                 (4, 64), (8, 72)])
def test_settle_scan_plain_equals_the_composition_it_replaced(c, w):
    cfg = AvalancheConfig(finalization_score=40)
    win = random_window(c * w, 37, w, c, cfg.finalization_score)
    got = sdg.settle_scan_plain(*win.values(), c, cfg)
    want = old_settle_composition(*win.values(), c, cfg)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)
    # The draw holds both outcomes of the set test.
    assert 0 < int(got[0].sum()) < w // c


def _pretend_card(monkeypatch):
    """Route CPU tensors as the card would, with the kernels' plain
    versions standing in for them; returns the stand-ins' call counts."""
    card = torch.device("cuda")
    scan_route = scheduler.settle_scan_route
    calls = {"settle_scan": 0, "refill": 0}

    def settle_scan(*args):
        calls["settle_scan"] += 1
        return sdg.settle_scan_plain(*args)

    def refill(*args):
        calls["refill"] += 1
        return sdg.refill_plain(*args)

    monkeypatch.setattr(scheduler, "settle_scan_route",
                        lambda dev, c: scan_route(card, c))
    monkeypatch.setattr(scheduler, "refill_route", lambda dev: True)
    monkeypatch.setattr(scheduler, "settle_scan", settle_scan)
    monkeypatch.setattr(scheduler, "refill", refill)
    return calls


STEP_ROUTES = {   # name -> (stream_state knobs, kernel calls a step)
    "dense": (dict(), (1, 1)),
    "untracked": (dict(track_finality=False), (1, 1)),
    "sets_of_4": (dict(c=4, window_sets=3), (1, 1)),
    "sets_of_3": (dict(c=3, window_sets=4), (0, 1)),
    "retire_cap": (dict(stream_retire_cap=2), (1, 0)),
}


@pytest.mark.parametrize("name", sorted(STEP_ROUTES))
def test_steps_route_as_on_the_card(name, monkeypatch):
    """Steps routed as on the card equal plain steps leaf for leaf, and
    the stand-ins run exactly where the routes send them: the settle
    scan for a set size dividing 8, the refill unless the retire cap
    rewrites columns.  Then the end-of-run harvest (no refill) and
    `drained`."""
    knobs, (scans, refills) = STEP_ROUTES[name]
    state, cfg = stream_state(**knobs)
    plain = routed = state
    plain_tels = []
    for _ in range(30):
        plain, tel = sdg.step(plain, cfg)
        plain_tels.append(tel)
    calls = _pretend_card(monkeypatch)
    for r in range(30):
        routed, tel = sdg.step(routed, cfg)
        assert_equal_trees(plain_tels[r], tel, f"{name} step {r}")
    assert calls == {"settle_scan": 30 * scans, "refill": 30 * refills}
    assert int(routed.outputs.settled.sum()) > 0
    assert_equal_trees(plain, routed, name)
    harvested = sdg._retire_and_refill(routed, cfg, refill=False)[0]
    monkeypatch.undo()
    assert_equal_trees(sdg._retire_and_refill(plain, cfg, refill=False)[0],
                       harvested, f"{name} harvest")


def test_cpu_steps_launch_no_scheduler_kernel():
    """CPU steps launch nothing and count no plain route: the count is
    of card tensors that missed a kernel."""
    before = dict(scheduler.launches), dict(scheduler.plain_routes)
    for knobs in ({}, dict(c=3, window_sets=4), dict(stream_retire_cap=2)):
        state, cfg = stream_state(**knobs)
        for _ in range(3):
            state = sdg.step(state, cfg)[0]
        sdg.drained(state, cfg)
    assert (scheduler.launches, scheduler.plain_routes) == before


def test_wrappers_refuse_before_any_launch():
    cfg = AvalancheConfig()
    before = dict(scheduler.launches)
    win = random_window(0, 4, 12, 3, cfg.finalization_score)
    with pytest.raises(ValueError, match="must divide 8"):
        scheduler.settle_scan(*win.values(), 3, cfg)
    win = random_window(0, 4, 12, 2, cfg.finalization_score)
    with pytest.raises(TypeError, match="confidence must be"):
        scheduler.settle_scan(win["confidence"].to(torch.int32),
                              *list(win.values())[1:], 2, cfg)
    with pytest.raises(ValueError, match="valid must have shape"):
        scheduler.settle_scan(*list(win.values())[:3], win["valid"][:-2],
                              2, cfg)
    records, added, fin, take, occ, pref = random_planes(0, 4, 12, True)
    with pytest.raises(ValueError, match="take_w must have shape"):
        scheduler.refill(records, added, fin, take[:-2], occ, pref)
    with pytest.raises(ValueError, match="contiguous"):
        scheduler.refill(records, added, fin.t().contiguous().t(), take,
                         occ, pref)
    assert scheduler.launches == before


def test_kernel_calls_run_inside_a_torch_op(monkeypatch):
    """The profiler places a device kernel under the innermost torch op
    open when it was launched: each C entry runs inside `_build.Launch`,
    once a wrapper call, with its status checked (a stand-in entry on
    the CPU)."""
    from torch.profiler import ProfilerActivity, profile

    entered = []
    monkeypatch.setattr(scheduler, "_kernel",
                        lambda name: lambda *args: entered.append(name) or 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(scheduler, "launches",
                        dict.fromkeys(scheduler.launches, 0))
    cfg = AvalancheConfig()
    win = random_window(1, 6, 16, 2, cfg.finalization_score)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pending, accept = scheduler.settle_scan(*win.values(), 2, cfg)
        out = scheduler.refill(*random_planes(1, 6, 16, False))
    ops = [e.name() for e in prof.profiler.kineto_results.events()]
    assert entered == ["settle_scan", "refill"]
    assert ops.count("Launch") == 2
    assert scheduler.launches == {"settle_scan": 1, "refill": 1}
    assert (pending.shape, accept.shape) == ((8,), (16,))
    assert out[2] is None and out[1].shape == (6, 16)
    monkeypatch.setattr(scheduler, "_kernel", lambda name: lambda *a: 700)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        scheduler.settle_scan(*win.values(), 2, cfg)


# --------------------------------------------------------- on the card

SCAN_CASES = {   # name -> (n, w, c, finalization score)
    "stream_width": (1000, 2048, 2, 128),
    "ragged_rows": (333, 2048, 2, 128),
    "ragged_width": (301, 1998, 2, 128),
    "width_not_a_block": (257, 2000, 2, 64),
    "singletons": (130, 520, 1, 128),
    "sets_of_4": (130, 1028, 4, 7),
    "sets_of_8": (97, 1032, 8, 128),
    "score_7fff": (200, 1024, 2, 0x7FFF),
    "score_1": (200, 1024, 2, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_settle_scan_matches_plain(case, cuda):
    n, w, c, score = SCAN_CASES[case]
    cfg = AvalancheConfig(finalization_score=score)
    win = random_window(n + w, n, w, c, score, cuda)
    before = scheduler.launches["settle_scan"]
    got = scheduler.settle_scan(*win.values(), c, cfg)
    torch.cuda.synchronize()
    assert scheduler.launches["settle_scan"] == before + 1
    want = sdg.settle_scan_plain(*win.values(), c, cfg)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and torch.equal(g, x)


@pytest.mark.cuda
def test_settle_scan_general_path_on_a_misaligned_view(cuda):
    """Planes that start 2 elements into their storage take the kernel's
    general path."""
    n, w, c = 150, 1024, 2
    cfg = AvalancheConfig()
    win = random_window(5, n, w + 2, c, cfg.finalization_score, cuda)
    conf = win["confidence"].reshape(-1)[2:2 + n * w].view(n, w)
    added = win["added"].reshape(-1)[2:2 + n * w].view(n, w)
    args = (conf, added, win["alive"], win["valid"][:w], c, cfg)
    for g, x in zip(scheduler.settle_scan(*args),
                    sdg.settle_scan_plain(*args)):
        assert torch.equal(g, x)


REFILL_CASES = {   # name -> (n, w, finality tracked)
    "stream_width": (1000, 2048, True),
    "untracked": (1000, 2048, False),
    "ragged_rows": (333, 2048, True),
    "ragged_width": (301, 1998, True),
    "ragged_width_untracked": (301, 1998, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(REFILL_CASES))
def test_refill_matches_plain_and_writes_no_input(case, cuda):
    n, w, tracked = REFILL_CASES[case]
    args = random_planes(n + w, n, w, tracked, cuda)
    copies = [None if a is None else (
        vr.VoteRecordState(*(p.clone() for p in a))
        if isinstance(a, tuple) else a.clone()) for a in args]
    before = scheduler.launches["refill"]
    got = scheduler.refill(*args)
    torch.cuda.synchronize()
    assert scheduler.launches["refill"] == before + 1
    assert_equal_trees(sdg.refill_plain(*args), got, case)
    assert_equal_trees(tuple(copies), tuple(args), f"{case} inputs")
    nothing = scheduler.refill(*args[:3], torch.zeros_like(args[3]),
                               *args[4:])
    assert_equal_trees(sdg.refill_plain(*args[:3], torch.zeros_like(
        args[3]), *args[4:]), nothing, f"{case} nothing taken")


@pytest.mark.cuda
@pytest.mark.parametrize("tracked", [True, False])
def test_stream_run_card_route_matches_cpu(tracked, cuda):
    """A stream run to its end on the card, through both kernels, equals
    the same run on the CPU leaf for leaf, telemetry of every step too;
    each step launches each kernel once."""
    state, cfg = stream_state(n=301, window_sets=64, n_sets=400,
                              track_finality=tracked)
    cpu_rows, cpu = [], state
    for _ in range(40):
        cpu, tel = sdg.step(cpu, cfg)
        cpu_rows.append(tel)
    before = dict(scheduler.launches)
    plain_before = dict(scheduler.plain_routes)
    card = av.move_leaves(state, cuda)
    for r in range(40):
        card, tel = sdg.step(card, cfg)
        assert_equal_trees(cpu_rows[r], tel, f"step {r}")
    assert {k: scheduler.launches[k] - before[k] for k in before} == {
        "settle_scan": 40, "refill": 40}
    assert scheduler.plain_routes == plain_before
    assert int(card.outputs.settled.sum()) > 0
    assert_equal_trees(cpu, card, "40 steps")
    assert_equal_trees(sdg.run(cpu, cfg, max_rounds=300, device="cpu"),
                       sdg.run(card, cfg, max_rounds=300, device=cuda),
                       "run and harvest")


@pytest.mark.cuda
@pytest.mark.parametrize("knobs,counts", [
    (dict(c=3, window_sets=4), {"settle_scan": (0, 1), "refill": (1, 0)}),
    (dict(stream_retire_cap=2), {"settle_scan": (1, 0), "refill": (0, 1)}),
], ids=["sets_of_3", "retire_cap"])
def test_card_steps_count_their_plain_routes(knobs, counts, cuda):
    """On the card a set size the scan does not take and the retire
    cap's column rewrite run plainly, equal to the CPU's steps, and
    each such call counts in `plain_routes`: (launches, plain routes)
    a step per kernel."""
    state, cfg = stream_state(**knobs)
    cpu, card = state, av.move_leaves(state, cuda)
    before = {k: (scheduler.launches[k], scheduler.plain_routes[k])
              for k in counts}
    for r in range(12):
        cpu, want = sdg.step(cpu, cfg)
        card, tel = sdg.step(card, cfg)
        assert_equal_trees(want, tel, f"step {r}")
    assert_equal_trees(cpu, card, "12 steps")
    assert {k: (scheduler.launches[k] - before[k][0],
                scheduler.plain_routes[k] - before[k][1])
            for k in counts} == {k: (12 * a, 12 * b)
                                 for k, (a, b) in counts.items()}


@pytest.mark.cuda
def test_scheduler_kernels_read_under_retire_refill(cuda):
    """Under the profiler each step's two kernels are linked to a host op
    that started inside that step's `retire_refill` span
    (`round_profile._by_span`'s rule): exactly one of each a step.

    The first step of a profiler session is held only to at most one of
    each.  On the H100 (torch 2.11, CUDA 12.8) a session loses its first
    device records now and then: in a process that had run other
    profiler sessions, the first 22-24 kernels of 39 sessions in 40
    (among them a step's settle scan, its third kernel); in a fresh
    process, the first 53 in one session of 80.  Never a kernel after
    the first step, so the steps after it are counted exactly."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    state, cfg = stream_state(n=301, window_sets=64, n_sets=400,
                              device=cuda)
    state = sdg.step(state, cfg)[0]       # builds and loads the kernels
    torch.cuda.synchronize()
    steps = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps + 1):
            state = sdg.step(state, cfg)[0]
        torch.cuda.synchronize()
    symbols = ("settle_scan_kernel", "refill_kernel")
    started, spans, kernels = {}, [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU and e.linked_correlation_id() == 0:
            started[e.correlation_id()] = e.start_ns()
            if e.name() == "retire_refill":
                spans.append((e.start_ns(), e.end_ns()))
        elif (e.device_type() == DeviceType.CUDA
              and not e.is_user_annotation()
              and any(symbol in e.name() for symbol in symbols)):
            kernels.append((e.name(), e.linked_correlation_id()))
    spans.sort()
    assert len(spans) == steps + 1
    per_step = [dict.fromkeys(symbols, 0) for _ in spans]
    for name, linked in kernels:
        at = started.get(linked)
        assert at is not None, f"{name[:60]} is linked to no host op"
        inside = [i for i, (lo, hi) in enumerate(spans) if lo <= at < hi]
        assert inside, f"{name[:60]} was launched outside retire_refill"
        for symbol in symbols:
            per_step[inside[0]][symbol] += symbol in name
    assert all(n <= 1 for n in per_step[0].values()), per_step[0]
    assert per_step[1:] == [dict.fromkeys(symbols, 1)] * steps, per_step
