"""The port's protocol models (deepflow_tpu_torch/analysis/model/) against
the JAX package's, on the CPU.

The JAX package's `tests/test_model.py` runs against the port
(`torch_ctl_pair.adopt_reference_tests`): the models' conformance is
checked against the port's own code (`agent/sender.py`,
`runtime/{receiver,spill}.py`, `parallel/{pod,multihost}.py`) and its
own store, `analysis/stores/model-conform.json`. Beside them: each
model's `check()` gives the JAX package's state and transition counts
and verdict, and each seeded mutant's counterexample renders to the
same text in both packages."""

import re

import pytest
import torch_analysis_pair as ap
import torch_ctl_pair as cp

from deepflow_tpu.analysis import model as jmodel
from deepflow_tpu.analysis.model import mutate as jmutate
from deepflow_tpu_torch.analysis import model as tmodel
from deepflow_tpu_torch.analysis.model import mutate as tmutate

cp.adopt_reference_tests(
    globals(), ap.TESTS / "test_model.py",
    replace=ap.REPLACE + (
        ("from deepflow_tpu.runtime.faults",
         "from deepflow_tpu_torch.runtime.faults"),
    ))

_TIME = re.compile(r"elapsed=[0-9.]+s")


def _verdict(res):
    text = _TIME.sub("elapsed=", jmodel.render_trace(res))
    return (res.states, res.transitions, res.complete,
            res.violation is None, text)


@pytest.mark.parametrize("protocol", ["pod", "hostpod", "spill", "sender"])
def test_same_model_results(protocol):
    j = jmodel.check(jmodel.model_for(protocol), max_faults=2)
    t = tmodel.check(tmodel.model_for(protocol), max_faults=2)
    assert j.complete and j.violation is None
    assert _verdict(t) == _verdict(j)


def test_same_mutants_and_traces():
    jm, tm = jmutate.all_mutants(), tmutate.all_mutants()
    assert tm == jm and len(jm) >= 10
    for proto, name, _why in jm:
        j = jmodel.check(jmodel.model_for(proto, name), max_faults=2)
        t = tmodel.check(tmodel.model_for(proto, name), max_faults=2)
        assert j.violation is not None, (proto, name)
        assert _verdict(t) == _verdict(j), (proto, name)
