"""The port's wasm L7 plugin runtime (`deepflow_tpu_torch/agent/{wasm_vm,
wasm_asm,wasm_samples,wasm_plugin}.py`) against the JAX package's, on the
CPU.

The sample module (`build_memcached_wasm`, protocol 202) and a hostile
module assembled by each package's `wasm_asm` must be the same bytes.
Both packages' interpreters then run them on one seeded corpus of
memcached and foreign payloads with the same dispatch context: every
check, record, remaining fuel after each call, trap and counter must be
equal, at the default fuel and under budgets small enough to trap, and
the hostile module's stores past its memory and its `memory.grow` past
the cap must trap or fail alike. The JAX package's own wasm tests then
run against the port (`torch_ctl_pair.adopt_reference_tests`).
"""

import numpy as np
import pytest

import torch_ctl_pair as cp
from torch_plugin_pair import (agent_on_cpu, clean_registries,  # noqa: F401
                               memcached_corpus, record_tuple)

from deepflow_tpu.agent import wasm_asm as jasm
from deepflow_tpu.agent import wasm_plugin as jwp
from deepflow_tpu.agent import wasm_samples as jsamples
from deepflow_tpu_torch.agent import wasm_asm as tasm
from deepflow_tpu_torch.agent import wasm_plugin as twp
from deepflow_tpu_torch.agent import wasm_samples as tsamples

PKGS = (("jax", jwp), ("port", twp))


def hostile_module(asm):
    """df_check reads the ctx, stores a word at payload_size * 1024 (past
    the first page for payloads of 64 bytes and more) and returns
    memory.grow(payload_size & 7) (-1 past the module's 4 pages or the
    sandbox cap); df_parse reports an error."""
    m = asm.ModuleBuilder()
    t_v_i = m.functype([], [asm.I32])
    t_ii_i = m.functype([asm.I32, asm.I32], [asm.I32])
    rd = m.import_func("df_host", "read_ctx", t_ii_i)
    m.memory(1, 4)
    size = asm.i32_const(0) + asm.i32_load(47, 0)
    m.func(t_v_i, body=asm.i32_const(204), export="df_proto")
    m.func(t_v_i, body=(
        asm.i32_const(0) + asm.i32_const(64) + asm.call(rd) + asm.DROP
        + size + asm.i32_const(1024) + asm.I32_MUL + asm.i32_const(1)
        + asm.i32_store(0, 0)
        + size + asm.i32_const(7) + asm.I32_AND + asm.MEMORY_GROW),
        export="df_check")
    m.func(t_v_i, body=asm.i32_const(0), export="df_parse")
    return m.build()


def _ctxs(rng, n):
    return [dict(proto=int(rng.choice([6, 6, 17])),
                 port_src=int(rng.integers(1024, 65536)),
                 port_dst=int(rng.choice([11211, 11211, 80])),
                 ts_ns=int(rng.integers(0, 2**62)),
                 ip_src=int(rng.integers(0, 2**32)),
                 ip_dst=int(rng.integers(0, 2**32)),
                 ip_version=int(rng.choice([4, 6]))) for _ in range(n)]


def _run(mod, blob, corpus, ctxs, **kw):
    p = mod.WasmPlugin(blob, **kw)
    out = []
    for payload, ctx in zip(corpus, ctxs):
        ok = p.check(payload, **ctx)
        fuel_check = p.inst.fuel
        rec = record_tuple(p.parse(payload, **ctx))
        out.append((ok, fuel_check, rec, p.inst.fuel, p.traps,
                    len(p.inst.mem)))
    c = p.counters()
    c.pop("exe_us")
    return out, c


def test_modules_are_the_same_bytes():
    assert tsamples.build_memcached_wasm() == jsamples.build_memcached_wasm()
    assert (tsamples.PROTO_ID, tsamples.NAME) == (202, b"Memcached-wasm")
    assert hostile_module(tasm) == hostile_module(jasm)


def test_vms_equal_on_the_corpus():
    """The sample on the default fuel: records, fuel left after every
    check and parse, traps and counters equal."""
    rng = np.random.default_rng(0x60)
    corpus = memcached_corpus(rng, 96)
    ctxs = _ctxs(rng, len(corpus))
    blob = jsamples.build_memcached_wasm()
    j, t = (_run(mod, blob, corpus, ctxs) for _, mod in PKGS)
    assert t == j
    recs = [r[2] for r in j[0] if r[2] is not None]
    assert {r[0] for r in recs} == {202} and len(recs) > 20
    assert j[1]["failures"] > 0 and j[1]["traps"] == 0


@pytest.mark.parametrize("fuel", [300, 2_000, 20_000])
def test_fuel_traps_equal(fuel):
    """Budgets that run out on some payloads and not others: the same
    payloads trap in both interpreters, at the same fuel."""
    rng = np.random.default_rng((0x61, fuel))
    corpus = memcached_corpus(rng, 120)
    ctxs = _ctxs(rng, len(corpus))
    blob = jsamples.build_memcached_wasm()
    j, t = (_run(mod, blob, corpus, ctxs, fuel=fuel) for _, mod in PKGS)
    assert t == j
    assert j[1]["traps"] > 0
    if fuel == 20_000:
        assert any(r[0] for r in j[0])


@pytest.mark.parametrize("max_pages", [2, 64])
def test_memory_traps_equal(max_pages):
    """The hostile module: out-of-bounds stores trap and memory.grow
    stops at min(module max, sandbox cap) alike."""
    rng = np.random.default_rng((0x62, max_pages))
    corpus = memcached_corpus(rng, 150)
    ctxs = _ctxs(rng, len(corpus))
    blob = hostile_module(jasm)
    j, t = (_run(mod, blob, corpus, ctxs, max_pages=max_pages)
            for _, mod in PKGS)
    assert t == j
    checks = [r[0] for r in j[0]]
    pages = {r[5] // 65536 for r in j[0]}
    assert j[1]["traps"] > 0 and any(checks) and not all(checks)
    assert max(pages) == min(4, max_pages)
    assert j[1]["failures"] >= len(corpus) - j[1]["traps"]


def test_registry_dispatch_equal():
    """Each package's registry with the sample loaded answers
    parse_payload alike; unloading restores the built-in answers."""
    rng = np.random.default_rng(0x63)
    corpus = memcached_corpus(rng, 120)
    ctxs = _ctxs(rng, len(corpus))
    from deepflow_tpu.agent import l7 as jl7
    from deepflow_tpu_torch.agent import l7 as tl7

    def answers(l7):
        return [record_tuple(l7.parse_payload(p, **c))
                for p, c in zip(corpus, ctxs)]
    bare = answers(jl7)
    assert answers(tl7) == bare
    blob = tsamples.build_memcached_wasm()
    jp, tp = jwp.load_wasm_plugin(blob), twp.load_wasm_plugin(blob)
    assert twp.loaded_wasm_plugins() == [tp]
    loaded = answers(jl7)
    assert answers(tl7) == loaded != bare
    assert twp.unload_wasm_plugin(tp) and jwp.unload_wasm_plugin(jp)
    assert twp.loaded_wasm_plugins() == []
    assert answers(tl7) == bare


# -- the JAX package's wasm tests, on the port --------------------------------
cp.adopt_reference_tests(globals(), cp.TESTS / "test_wasm.py")


@pytest.fixture(autouse=True)
def _ref_on_cpu(agent_on_cpu):  # noqa: F811
    """The adopted test bodies build `Agent(cfg)` without a device."""
