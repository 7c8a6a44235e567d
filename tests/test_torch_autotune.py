"""The port's feed autotuner (runtime/autotune.py) against the JAX
package's, tick for tick, and its knobs on the port's exporter, on the
CPU.

`FeedAutotuner.tick()` is the step the supervised thread runs, so the
control law is driven synchronously with the fake plant of the JAX
package's own tests (`metrics=`): both tuners see the same numbers, and
every knob value and counter must be equal after every tick. On the
port's exporter the knobs resize the stager, the feed and the pack pool,
and an autotuned exporter's sketch state equals its controller-off twin
leaf for leaf."""

import numpy as np
import pytest

from deepflow_tpu.runtime import autotune as jat
from deepflow_tpu_torch.models import flow_suite
from deepflow_tpu_torch.runtime import autotune as tat
from deepflow_tpu_torch.runtime.supervisor import default_supervisor
from deepflow_tpu_torch.runtime.tpu_sketch import TpuSketchExporter

_SMALL = dict(cms_log2_width=12, ring_size=256, hll_groups=64,
              hll_precision=8, entropy_log2_buckets=10)


class _FakeStager:
    def __init__(self, group_batches=1):
        self.group_batches = group_batches

    def set_group_batches(self, n):
        self.group_batches = max(1, int(n))


class _FakeFeed:
    def __init__(self):
        self.depth = 2
        self.coalesce = 1


class _FakePool:
    def __init__(self, active=2):
        self.active = active

    def resize(self, n):
        self.active = max(1, int(n))


class _FakeExporter:
    def __init__(self):
        self._stager = _FakeStager()
        self._feed = _FakeFeed()
        self._pack_pool = _FakePool()


class _Plant:
    """The JAX test's plant: busy peaks at (coalesce 4, depth 2,
    workers 2), every tick moves rows."""

    def __init__(self, exp):
        self.exp = exp
        self.rows = 0
        self.device_errors = 0
        self.crash_recoveries = 0
        self.degraded = 0.0
        self.frozen = False

    def __call__(self):
        if not self.frozen:
            self.rows += 1000
        busy = (1.0
                - 0.10 * abs(self.exp._stager.group_batches - 4)
                - 0.05 * abs(self.exp._feed.depth - 2)
                - 0.05 * abs(self.exp._pack_pool.active - 2))
        return {"busy": busy, "stall_s": 0.0, "dwell_s": 0.0,
                "dwell_batches": 0, "rows_in": self.rows,
                "device_errors": self.device_errors,
                "crash_recoveries": self.crash_recoveries,
                "degraded": self.degraded}


def _pair(**kw):
    """(port tuner, JAX tuner), each over its own fake exporter and
    plant."""
    out = []
    for mod in (tat, jat):
        exp = _FakeExporter()
        plant = _Plant(exp)
        kw.setdefault("interval_s", 1.0)
        out.append((mod.FeedAutotuner(exp, metrics=plant, **kw), exp,
                    plant))
    return out


def _trajectory(at, exp):
    return ((exp._stager.group_batches, exp._feed.depth,
             exp._pack_pool.active), at.counters(),
            [(k.name, k.direction, k.cooldown, k.cooldown_base, k.static)
             for k in at.knobs],
            None if at._trial is None else at._trial[0].name)


def _lockstep(pair, ticks):
    for i in range(ticks):
        for at, _, _ in pair:
            at.tick(dt=1.0)
        assert _trajectory(*pair[0][:2]) == _trajectory(*pair[1][:2]), i


@pytest.mark.parametrize("kw", [{}, {"deadband": 0.0},
                                {"max_coalesce": 3, "max_depth": 2}])
def test_converges_tick_for_tick_with_jax(kw):
    pair = _pair(**kw)
    try:
        _lockstep(pair, 80)
        (at, exp, _), _ = pair
        assert exp._stager.group_batches == min(4, kw.get("max_coalesce", 8))
        assert exp._feed.depth == 2 and exp._pack_pool.active == 2
        assert at.decisions >= 2 and at.reverts >= 3
        assert at.enabled and at.fallbacks == 0
    finally:
        for at, _, _ in pair:
            at.close()


def test_idle_intervals_never_judge():
    pair = _pair()
    try:
        _lockstep(pair, 3)
        for _, _, plant in pair:
            plant.frozen = True
        before = _trajectory(*pair[0][:2])[0]
        _lockstep(pair, 10)
        at = pair[0][0]
        assert _trajectory(at, pair[0][1])[0] == before
    finally:
        for at, _, _ in pair:
            at.close()


@pytest.mark.parametrize("incident", ["device_errors",
                                      "crash_recoveries", "degraded"])
def test_fallback_restores_static_config(incident):
    pair = _pair()
    try:
        _lockstep(pair, 8)
        assert pair[0][1]._stager.group_batches > 1
        for _, _, plant in pair:
            setattr(plant, incident, 1 if incident != "degraded" else 1.0)
        _lockstep(pair, 3)
        at, exp, _ = pair[0]
        assert not at.enabled and at.fallbacks == 1
        assert (exp._stager.group_batches, exp._feed.depth,
                exp._pack_pool.active) == (1, 2, 2)
        assert at.gauges() == pair[1][0].gauges()
        assert at.gauges()["tpu_autotune_enabled"] == 0.0
    finally:
        for at, _, _ in pair:
            at.close()


def test_gauges_and_registry_match_jax():
    pair = _pair()
    try:
        (at, _, _), (jt, _, _) = pair
        assert tat.AUTOTUNE_GAUGE_HELP == jat.AUTOTUNE_GAUGE_HELP
        assert set(at.gauges()) == set(tat.AUTOTUNE_GAUGE_HELP)
        assert set(at.counters()) == {k[len("tpu_autotune_"):]
                                      for k in at.gauges()}
        assert tat.autotune_gauges()["tpu_autotune_enabled"] == 1.0
    finally:
        for at, _, _ in pair:
            at.close()
    assert "tpu_autotune_enabled" not in tat.autotune_gauges()


def _exporter(**kw):
    return TpuSketchExporter(cfg=flow_suite.FlowSuiteConfig(**_SMALL),
                             batch_rows=512, window_seconds=3600,
                             device="cpu", **kw)


@pytest.mark.parametrize("wire", ["dict", "lanes"])
def test_real_exporter_knob_surface_and_supervision(wire):
    """The knobs are the stager's coalesce width (applied when the next
    group opens), the feed's depth (with the stager's free-list cap
    following it) and the pool's routing width; the control thread
    rides the supervision tree."""
    e = _exporter(wire=wire, prefetch_depth=2, coalesce_batches=2,
                  pack_workers=2)
    at = tat.FeedAutotuner(e, interval_s=0.1)
    try:
        assert [k.name for k in at.knobs] == [
            "coalesce_batches", "prefetch_depth", "pack_workers"]
        assert [k.static for k in at.knobs] == [2, 2, 2]
        knobs = {k.name: k for k in at.knobs}
        knobs["coalesce_batches"].set(3)
        assert e._stager._pending_group == 3 and e._stager.group_batches == 2
        knobs["prefetch_depth"].set(5)
        assert e._feed.depth == 5 and e._stager._pool_cap == 7
        knobs["pack_workers"].set(3)
        assert e._pack_pool.active == 3 and e._pack_pool.n_workers == 3
        knobs["pack_workers"].set(1)
        assert e._pack_pool.active == 1 and e._pack_pool.n_workers == 3
        at.start()
        assert "feed-autotune" in {t["name"]
                                   for t in default_supervisor().threads()}
    finally:
        at.close()
        e.close()
    assert not at.enabled


@pytest.mark.parametrize("wire", ["dict", "lanes"])
def test_autotuned_exporter_equals_controller_off_twin(wire):
    """Knob moves between chunks (a plant that rewards wide coalescing)
    change group widths, depth and routing mid-window; every leaf of
    every window snapshot equals the controller-off twin's."""
    rng = np.random.default_rng(31)
    base = {"ip_src": rng.integers(0, 1 << 32, 600, dtype=np.uint32),
            "ip_dst": rng.integers(0, 1 << 32, 600, dtype=np.uint32),
            "port_src": rng.integers(0, 1 << 16, 600).astype(np.uint32),
            "port_dst": rng.integers(0, 1 << 16, 600).astype(np.uint32),
            "proto": rng.choice([6, 17], 600).astype(np.uint32)}
    windows = []
    for _ in range(2):
        pick = (rng.zipf(1.2, 9000) - 1).clip(max=599)
        cols = {k: v[pick] for k, v in base.items()}
        cols["packet_tx"] = rng.integers(1, 64, 9000).astype(np.uint32)
        cols["packet_rx"] = rng.integers(1, 64, 9000).astype(np.uint32)
        windows.append(cols)
    snaps = {}
    moves = []
    for name in ("off", "tuned"):
        e = _exporter(wire=wire, prefetch_depth=2, pack_workers=2)
        got = snaps[name] = []
        e.snapshot_bus.subscribe(lambda s, got=got: got.append(
            [np.asarray(a) for a in s.leaves]))
        at = None
        if name == "tuned":
            rows = [0]

            def plant():
                rows[0] += 1
                return {"busy": 0.1 * e._stager.group_batches,
                        "stall_s": 0.0, "dwell_s": 0.0, "dwell_batches": 0,
                        "rows_in": rows[0], "device_errors": 0,
                        "crash_recoveries": 0, "degraded": 0.0}
            at = tat.FeedAutotuner(e, metrics=plant, interval_s=1.0)
        try:
            for w, cols in enumerate(windows):
                for s in range(0, 9000, 700):
                    e.process([("l4_flow_log", 0,
                                {k: v[s:s + 700] for k, v in cols.items()},
                                -1)])
                    if at is not None:
                        at.tick(dt=1.0)
                        moves.append((e._stager.group_batches, e._feed.depth,
                                      e._pack_pool.active))
                e.flush_window(now=100.0 + w)
        finally:
            if at is not None:
                at.close()
            e.close()
    assert len({m[0] for m in moves}) >= 3 and len(set(moves)) >= 4
    assert len(snaps["off"]) == len(snaps["tuned"]) == 2
    for a, b in zip(snaps["off"], snaps["tuned"]):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
