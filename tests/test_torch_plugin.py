"""The port's shared-object L7 plugin runtime (`deepflow_tpu_torch/agent/
plugin.py`, its copy of `native_src/`) against the JAX package's, on the
CPU.

Two builds of the memcached sample, one from each package's copy of the
C++ source, are loaded by each package's `SoPlugin` and offered the same
seeded corpus (memcached requests and responses, foreign protocols, near
misses, random bytes) with the same dispatch context: every `check`,
`parse` record and counter must be equal. The port's first-use build
(`build_sample_plugin`) is the one the agent process and the chip run
load. The JAX package's own plugin tests then run against the port
(`torch_ctl_pair.adopt_reference_tests`), the sample built from the
port's copy. Every plugin a test registers is unloaded afterwards
(`torch_plugin_pair.clean_registries`).
"""

import numpy as np
import pytest

import torch_ctl_pair as cp
from torch_plugin_pair import (JAX_NATIVE, PORT_NATIVE, agent_on_cpu,  # noqa: F401
                               build_so, clean_registries,
                               memcached_corpus, needs_gxx, record_tuple)

from deepflow_tpu.agent import l7 as jl7
from deepflow_tpu.agent import plugin as jplugin
from deepflow_tpu_torch.agent import l7 as tl7
from deepflow_tpu_torch.agent import plugin as tplugin

pytestmark = needs_gxx


@pytest.fixture(scope="module")
def builds(tmp_path_factory):
    d = tmp_path_factory.mktemp("so")
    return {"jax": build_so(JAX_NATIVE, d / "jax.so"),
            "port": build_so(PORT_NATIVE, d / "port.so")}


def _offer(mod, path, corpus, ctxs):
    p = mod.SoPlugin(path)
    out = []
    for payload, (proto, sp, dp, ts, si, di, v) in zip(corpus, ctxs):
        kw = dict(proto=proto, port_src=sp, port_dst=dp, ts_ns=ts,
                  ip_src=si, ip_dst=di, ip_version=v)
        out.append((p.check(payload, **kw),
                    record_tuple(p.parse(payload, **kw))))
    c = p.counters()
    c.pop("exe_us")
    return out, c, (p.proto, p.name, p.transports)


def _ctxs(rng, n):
    return [(int(rng.choice([6, 6, 6, 17])), int(rng.integers(1024, 65536)),
             int(rng.choice([11211, 11211, 80])), int(rng.integers(0, 2**62)),
             int(rng.integers(0, 2**32)), int(rng.integers(0, 2**32)),
             int(rng.choice([4, 6]))) for _ in range(n)]


def test_two_builds_give_equal_records(builds):
    """The same corpus through both packages' loaders and both copies of
    the source: checks, records and counters equal in all four pairings."""
    rng = np.random.default_rng(0x50)
    corpus = memcached_corpus(rng)
    ctxs = _ctxs(rng, len(corpus))
    runs = {(m, b): _offer(mod, builds[b], corpus, ctxs)
            for m, mod in (("jax", jplugin), ("port", tplugin))
            for b in ("jax", "port")}
    ref = runs[("jax", "jax")]
    for key, got in runs.items():
        assert got == ref, key
    outs, counters, ident = ref
    assert ident == (201, "Memcached", (6,))
    parsed = [r for _, r in outs if r is not None]
    # the corpus reaches both message types, an error status and the
    # endpoint's truncation at 127 bytes (command, space, key)
    assert {r[1] for r in parsed} == {jl7.MSG_REQUEST, jl7.MSG_RESPONSE}
    assert any(r[3] == 1 for r in parsed)
    assert max(len(r[2]) for r in parsed) == 127
    assert counters["failures"] > 0


def test_first_use_build_matches_the_reference_build(builds):
    """`build_sample_plugin` (the agent process's and the chip run's
    library) gives the JAX build's records, and a second call reuses the
    library."""
    rng = np.random.default_rng(0x51)
    corpus = memcached_corpus(rng, 120)
    ctxs = _ctxs(rng, len(corpus))
    path = tplugin.build_sample_plugin()
    assert path == tplugin.build_sample_plugin()
    assert str(tplugin.NATIVE_SRC) == str(PORT_NATIVE)
    assert _offer(tplugin, path, corpus, ctxs) == \
        _offer(jplugin, builds["jax"], corpus, ctxs)


def test_registry_dispatch_equal(builds):
    """Each package's registry with its plugin loaded answers
    `parse_payload` alike (built-ins first, the plugin on what they
    leave), and unloading restores the built-in answers."""
    rng = np.random.default_rng(0x52)
    corpus = memcached_corpus(rng, 200) + [b"GET /x HTTP/1.1\r\n\r\n",
                                           b"HTTP/1.1 200 OK\r\n\r\n"]
    ctxs = _ctxs(rng, len(corpus))

    def answers(l7):
        return [record_tuple(l7.parse_payload(
            p, proto=c[0], port_src=c[1], port_dst=c[2], ts_ns=c[3],
            ip_src=c[4], ip_dst=c[5], ip_version=c[6]))
            for p, c in zip(corpus, ctxs)]
    bare = answers(jl7)
    assert answers(tl7) == bare
    jp = jplugin.load_so_plugin(builds["jax"])
    tp = tplugin.load_so_plugin(builds["port"])
    assert tplugin.loaded_plugins() == [tp]
    loaded = answers(jl7)
    assert answers(tl7) == loaded
    assert any(r is not None and r[0] == 201 for r in loaded)
    assert tplugin.unload_so_plugin(tp) and jplugin.unload_so_plugin(jp)
    assert not tplugin.unload_so_plugin(tp)
    assert answers(tl7) == bare == answers(jl7)


# -- the JAX package's plugin tests, on the port ------------------------------
_REF_MOD = cp.adopt_reference_tests(globals(), cp.TESTS / "test_plugin.py")
# the sample builds from the port's copy of native_src
_REF_MOD.SRC = PORT_NATIVE


@pytest.fixture(autouse=True)
def _ref_on_cpu(agent_on_cpu):  # noqa: F811
    """The adopted test bodies build `Agent(cfg)` without a device."""
