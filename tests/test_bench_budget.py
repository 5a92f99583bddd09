"""Unit tests for bench.Budget — the indestructible-artifact machinery.

A bench that prints its only JSON line at the very end loses every
measured number to a timeout; Budget is the fix: incremental emission
after every stage, wall-clock gating between stages, and a stage-time
sidecar that replaces cold-compile estimates with measured wall times.
Mirrors the reference's always-logged per-solve timing
(/root/reference/dgfem/solver.py:29-53).
"""

import json
import signal

import pytest


@pytest.fixture()
def make_budget(tmp_path):
    import bench

    def make(budget_s):
        b = bench.Budget(budget_s)
        # isolate the sidecar: don't read from / write to the repo's
        # .jax_cache during tests
        b._times_path = str(tmp_path / "stage_times.json")
        b._stage_times = {}
        return b

    yield make
    # Budget installs SIGTERM/SIGINT dump handlers — restore the defaults
    # so later tests (and pytest's own Ctrl-C handling) are unaffected
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.default_int_handler)


def _last_json_line(capsys):
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    return json.loads(lines[-1])


def test_emit_prints_complete_json_every_time(make_budget, capsys):
    b = make_budget(60)
    b.result.update({"metric": "x", "value": 1})
    b.emit()
    first = _last_json_line(capsys)
    assert first["metric"] == "x" and first["value"] == 1
    assert "bench_wall_s" in first and "skipped" in first

    b.result["stage2"] = {"ok": True}
    b.emit()
    second = _last_json_line(capsys)
    # the later line is a strict-superset snapshot — the driver parses
    # the LAST line, which must always be the most complete one
    assert second["stage2"] == {"ok": True}
    assert second["metric"] == "x"


def test_fits_gates_on_remaining_and_records_skip(make_budget):
    b = make_budget(10)
    assert b.fits(5, "cheap") is True
    assert b.result["skipped"] == []
    # a stage estimated beyond the remaining budget is skipped + recorded
    assert b.fits(10_000, "expensive") is False
    assert [s["stage"] for s in b.result["skipped"]] == ["expensive"]
    assert b.result["skipped"][0]["est_s"] == 10_000


def test_sidecar_prior_overrides_estimate(make_budget):
    # without a prior, a 9999 s estimate cannot fit a 30 s budget
    b = make_budget(30)
    assert b.fits(9_999, "stage_a") is False
    # a 2 s wall time measured on an earlier (warm-cache) run replaces the
    # cold estimate: 2*1.25+10 = 12.5 s <= 30 s remaining
    b2 = make_budget(30)
    b2._stage_times = {"stage_a": 2.0}
    assert b2.fits(9_999, "stage_a") is True


def test_sidecar_prior_can_also_force_a_skip(make_budget):
    b = make_budget(5)
    b._stage_times = {"big": 100.0}
    # measured prior 100 s -> est 135 s > 5 s budget: skip despite the
    # optimistic caller estimate
    assert b.fits(1, "big") is False
    assert b.result["skipped"][0]["stage"] == "big"


def test_stage_times_recorded_and_persisted(make_budget):
    b = make_budget(60)
    assert b.fits(1, "s1")
    assert b.fits(1, "s2")  # closes s1, records + persists its wall time
    assert "s1" in b._stage_times and b._stage_times["s1"] >= 0.0
    with open(b._times_path) as f:
        assert "s1" in json.load(f)


# ---------------------------------------------------------------------------
# Parent orchestrator: bounded subprocess stages.  One un-gated compile can
# outlast any estimate; the orchestrator bounds every stage with a hard
# timeout and salvages the child's SIGTERM-dumped partial snapshot.
# ---------------------------------------------------------------------------


def test_last_json_dict_takes_last_complete_snapshot():
    import bench
    text = "\n".join([
        "# stderr-ish noise",
        json.dumps({"value": 1}),
        "not json {",
        json.dumps({"value": 2, "more": True}),
        '{"truncated": ',
    ])
    assert bench._last_json_dict(text) == {"value": 2, "more": True}
    assert bench._last_json_dict("") is None
    assert bench._last_json_dict(None) is None


def test_merge_child_preserves_parent_bookkeeping():
    import bench
    result = {"skipped": [{"stage": "earlier"}], "bench_wall_s": 1.0,
              "scaling": [{"grid_n": 8}]}
    child = {"value": 0.03, "impl": "soa_fused",
             "skipped": [{"stage": "inner"}],
             "bench_wall_s": 99.0, "terminated_by": "SIGTERM",
             "scaling": [{"grid_n": 16}]}
    bench._merge_child(result, child)
    assert result["value"] == 0.03
    # parent wall-clock/termination bookkeeping survives the merge
    assert result["bench_wall_s"] == 1.0
    assert "terminated_by" not in result
    # child skips append, scaling entries accumulate
    assert [s["stage"] for s in result["skipped"]] == ["earlier", "inner"]
    assert [e["grid_n"] for e in result["scaling"]] == [8, 16]
    # a None / empty child is a no-op
    bench._merge_child(result, None)
    assert result["value"] == 0.03


def test_plan_for_covers_every_orchestrated_stage():
    import bench
    for stage in ("probe", "flagship", "stokes", "configs",
                  "scaling:16", "scaling:64"):
        est, cap = bench._plan_for(stage)
        assert 0 < est <= cap, stage


def test_run_child_stage_timeout_salvages_partial(make_budget):
    """A child that hangs after emitting a snapshot: the parent must kill
    it at the cap, recover the emitted JSON, and record the timeout."""
    import bench
    b = make_budget(600)
    parsed, timed_out, rc = bench._run_child_stage(
        b, "_sleep_test", 12.0, [], ["--backend", "cpu"])
    assert timed_out is True
    assert parsed is not None and parsed["sleep_marker"] == 1
    skip = b.result["skipped"][-1]
    assert skip["stage"] == "_sleep_test"
    assert skip["reason"] == "stage_timeout"
    assert skip["partial_recovered"] is True
    assert b.result["stage_walls"]["_sleep_test"]["timed_out"] is True


def test_run_child_stage_stall_detector_kills_and_retries(make_budget,
                                                          monkeypatch):
    """A child that produces NO stdout (wedged before its first device op)
    must be killed at the stall window and retried once — not left to burn the
    stage's full hard cap in silence."""
    import bench
    monkeypatch.setattr(bench, "_STALL_S", 6)
    b = make_budget(600)
    t0 = __import__("time").monotonic()
    parsed, timed_out, rc = bench._run_child_stage(
        b, "_stall_test", 60.0, [], ["--backend", "cpu"])
    wall = __import__("time").monotonic() - t0
    assert timed_out is False
    skip = b.result["skipped"][-1]
    assert skip["stage"] == "_stall_test"
    assert skip["reason"] == "stage_stalled"
    assert b.result["stage_walls"]["_stall_test"]["stall_attempts"] == 2
    # two stall windows + kill grace, nowhere near the 60 s cap
    assert wall < 45


def test_cancel_stage_drops_timed_out_wall_times(make_budget):
    """A stage killed at its hard cap must NOT record its wall time as a
    sidecar prior — the elapsed time reflects the bound, not the cost,
    and recording it would force the next run to skip the stage."""
    b = make_budget(600)
    assert b.fits(5, "hog")
    b.cancel_stage()
    assert b.fits(5, "next")
    assert "hog" not in b._stage_times
    assert "next" in [s for s, _ in [b._open_stage]]
