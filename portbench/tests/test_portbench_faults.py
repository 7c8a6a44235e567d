"""The comparison fails what it must: a whole run on the CPU, past the
harness's look for a card, with the timed path broken underneath (a
step that leaves its state unchanged, half of each batch left out, an
answer altered where it is produced, a window's store rows left
unwritten), and the control, the reference in the program's place with
bfloat16 readouts. A sound run beside them comes out correct. (One
card, one process: there is no exchange between chips to leave out.)"""

import io

import pytest
import torch

import control
from deepflow_tpu_torch.models import app_suite, flow_dict, flow_suite
from deepflow_tpu_torch.ops import topk
from deepflow_tpu_torch.runtime import tpu_sketch
from harness import run_cell

MIXES = {"l4_zipf_steady": "zipf_steady",
         "red_zipf_services": "red_services"}


def _run(cell, small_mix, seed=2**31 + 17):
    return run_cell.run(cell, seed, 2.0, False, device="cpu",
                        mix=small_mix(MIXES[cell]), log=io.StringIO())


def _over(result, *names):
    """Every named number read above its limit, and the run not correct."""
    assert result["correct"] is False
    for n in names:
        c = result["checks"][n]
        assert not run_cell.within(c["value"], c["limit"]), (n, c)


def _wire(monkeypatch, edit):
    orig = flow_dict.make_wire_update

    def make(cfg, sig):
        prog = orig(cfg, sig)
        return lambda st, ds, flat: edit(prog, st, ds, flat, len(sig))
    monkeypatch.setattr(flow_dict, "make_wire_update", make)


def test_sound_runs_are_correct(small_mix):
    for cell in ("l4_zipf_steady", "red_zipf_services"):
        r = _run(cell, small_mix)
        assert r["correct"] is True, r["checks"]
        assert r["failed"] == 0 and r["attempted"] > 0


def test_l4_state_left_unchanged(monkeypatch, small_mix):
    _wire(monkeypatch, lambda prog, st, ds, flat, p: (st, ds, flat[:p].sum()))
    _over(_run("l4_zipf_steady", small_mix), "rows_lost")


def test_l4_half_of_each_batch_left_out(monkeypatch, small_mix):
    def half(prog, st, ds, flat, p):
        flat = flat.clone()
        flat[:p] //= 2
        return prog(st, ds, flat)
    _wire(monkeypatch, half)
    _over(_run("l4_zipf_steady", small_mix), "rows_lost", "state_cells_off")


def test_l4_answer_altered(monkeypatch, small_mix):
    orig = flow_suite.flush

    def flush(state, cfg):
        fresh, out = orig(state, cfg)
        keys = out.topk_keys.clone()
        keys[0] ^= 1
        return fresh, out._replace(topk_keys=keys)
    monkeypatch.setattr(flow_suite, "flush", flush)
    _over(_run("l4_zipf_steady", small_mix), "topk_off", "topk_loss")


def test_l4_ring_admission_loses_flows(monkeypatch, small_mix):
    """A ring that is offered one batch record in 1024, not one in 16,
    stays self-consistent (topk_off reads 0) and loses mid-rank flows of
    the exact top-K: only topk_loss catches it."""
    orig = topk.candidate_keys

    def sparse(state_keys, batch_keys, mask=None, sample_log2=0, phase=0):
        return orig(state_keys, batch_keys, mask, 10, phase)
    monkeypatch.setattr(topk, "candidate_keys", sparse)
    r = _run("l4_zipf_steady", small_mix)
    _over(r, "topk_loss")
    assert r["checks"]["topk_off"]["value"] == 0


def test_l4_window_left_unwritten(monkeypatch, small_mix):
    orig = tpu_sketch.TpuSketchExporter._write_output
    calls = []

    def write(self, out, second):
        calls.append(second)
        if len(calls) != 2:
            orig(self, out, second)
    monkeypatch.setattr(tpu_sketch.TpuSketchExporter, "_write_output", write)
    _over(_run("l4_zipf_steady", small_mix), "unwritten")


def test_red_state_left_unchanged(monkeypatch, small_mix):
    monkeypatch.setattr(app_suite, "update",
                        lambda state, cols, mask, cfg: state)
    _over(_run("red_zipf_services", small_mix), "rows_lost")


def test_red_half_of_each_batch_left_out(monkeypatch, small_mix):
    orig = app_suite.update

    def update(state, cols, mask, cfg):
        keep = torch.arange(len(mask)) < mask.sum() // 2
        return orig(state, cols, mask & keep, cfg)
    monkeypatch.setattr(app_suite, "update", update)
    _over(_run("red_zipf_services", small_mix), "rows_lost", "counts_off")


def test_red_answer_altered(monkeypatch, small_mix):
    orig = app_suite.flush

    def flush(state, cfg):
        fresh, out = orig(state, cfg)
        q = out.rrt_quantiles.clone()
        q[1] *= 1.05                       # every p95 5% high
        return fresh, out._replace(rrt_quantiles=q)
    monkeypatch.setattr(app_suite, "flush", flush)
    _over(_run("red_zipf_services", small_mix), "quantile_gap")


@pytest.mark.parametrize("cell,number", [
    ("l4_zipf_steady", "readout_gap"), ("red_zipf_services", "quantile_gap")])
def test_control_is_not_correct(cell, number, small_mix):
    r = control.control(cell, 23, 60_000, 3,
                        mix=small_mix(MIXES[cell], 1 << 17))
    assert r["correct"] is False
    c = r["checks"][number]
    assert not run_cell.within(c["value"], c["limit"])
