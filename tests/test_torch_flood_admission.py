"""The top-K ring offered every lane (`topk_sample_log2=0`), the setting
of a deployment under a spoofed-source flood, against the JAX package on
the CPU, and the ingester knob that reaches it.

The stream is flood-shaped: 90% of each batch are one-packet flows whose
5-tuple never repeats, 10% come from a Zipf(1.1) pool, so the ring (256
slots) wraps on every batch and the dict packer evicts. Every state leaf
must equal the reference's after every staged buffer, and the window
outputs as in tests/test_torch_flow_suite.py. `IngesterConfig`'s
`tpu_sketch_topk_sample_log2` must reach the exporter's FlowSuiteConfig,
from the dataclass and from a server.yaml, and leave the default config
as it was."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deepflow_tpu.models import flow_dict as jfd
from deepflow_tpu.models import flow_suite as jfs
from deepflow_tpu_torch import convert
from deepflow_tpu_torch.models import flow_dict, flow_suite
from deepflow_tpu_torch.pipelines import Ingester, IngesterConfig
from deepflow_tpu_torch.server import ingester_config, load_config

REPO = Path(__file__).resolve().parent.parent
F32_TOL = dict(rtol=1e-5, atol=1e-6)
_SMALL = dict(cms_log2_width=12, ring_size=256, hll_groups=64,
              hll_precision=8, entropy_log2_buckets=10, topk_sample_log2=0)


def _flood(rng, n, first, pool=600, attack_share=0.9):
    """n records: attack rows with never-repeating (ip_src, port_src)
    from the running counter `first` against one victim, the rest drawn
    by Zipf(1.1) from a pool of 5-tuples fixed by the seed."""
    prng = np.random.default_rng(7)
    base = {
        "ip_src": prng.integers(0, 1 << 32, pool, dtype=np.uint64),
        "ip_dst": prng.integers(0, 1 << 32, pool, dtype=np.uint64),
        "port_src": prng.integers(1024, 1 << 16, pool),
        "port_dst": prng.choice([53, 80, 443, 3306, 8080], pool),
        "proto": prng.choice([6, 17], pool),
    }
    pick = (rng.zipf(1.1, n) - 1).clip(max=pool - 1)
    cols = {k: v[pick].astype(np.uint32) for k, v in base.items()}
    cols["packet_tx"] = rng.integers(1, 5000, n).astype(np.uint32)
    cols["packet_rx"] = rng.integers(0, 5000, n).astype(np.uint32)
    attack = rng.random(n) < attack_share
    ctr = first + np.arange(int(attack.sum()), dtype=np.uint64)
    cols["ip_src"][attack] = (0x0B000000 + ctr // 64510).astype(np.uint32)
    cols["port_src"][attack] = (1024 + ctr % 64510).astype(np.uint32)
    cols["ip_dst"][attack] = 0xAC10BEEF
    cols["port_dst"][attack] = 80
    cols["proto"][attack] = 6
    cols["packet_tx"][attack] = 1
    cols["packet_rx"][attack] = 0
    return cols, first + int(attack.sum())


def _bits(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32).copy())


def _assert_state_equal(ts, js, tdict, jdict):
    ref = jax.tree_util.tree_leaves(jax.device_get(js))
    got = convert.state_to_numpy(ts)
    for (name, _), a, b in zip(convert.SUITE_LEAVES, got, ref):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(convert.state_to_numpy(ts, tdict)[-1],
                                  np.asarray(jdict.table))


@pytest.mark.parametrize("fused", [None, True])
def test_flood_dict_wire_every_lane_offered_matches_jax(fused):
    B, cap = 1024, 2048
    jcfg = jfs.FlowSuiteConfig(**_SMALL)
    tcfg = flow_suite.FlowSuiteConfig(**_SMALL, fused_hists=fused)
    js = jfs.init(jcfg)
    jd = jfd.init_dict(cap)
    ts, td = convert.state_from_numpy(jax.device_get(js), jax.device_get(jd),
                                      device="cpu")
    jpack = jfd.FlowDictPacker(capacity=cap, hits_batch=B, news_batch=512)
    tpack = flow_dict.FlowDictPacker(capacity=cap, hits_batch=B,
                                     news_batch=512)
    jflush = jax.jit(lambda s: jfs.flush(s, jcfg))
    jprogs, tprogs = {}, {}
    rng = np.random.default_rng(31)
    first = 0
    for _window in range(2):
        for i in range(4):
            cols, first = _flood(rng, B - (37 if i % 2 else 0), first)
            jwire = jpack.pack(cols) + jpack.flush()
            twire = tpack.pack(cols) + tpack.flush()
            sig = flow_dict.wire_signature(twire)
            assert sig == jfd.wire_signature(jwire)
            flat = np.zeros(flow_dict.wire_words(sig), np.uint32)
            flow_dict.stage_wire(twire, flat)
            if sig not in jprogs:
                jprogs[sig] = jfd.make_wire_update(jcfg, sig)
                tprogs[sig] = flow_dict.make_wire_update(tcfg, sig)
            js, jd, _ = jprogs[sig](js, jd, jnp.asarray(flat))
            ts, td, _ = tprogs[sig](ts, td, _bits(flat))
            _assert_state_equal(ts, js, td, jd)
        js, jout = jflush(js)
        ts, tout = flow_suite.flush(ts, tcfg)
        np.testing.assert_array_equal(tout.topk_keys.numpy().view(np.uint32),
                                      np.asarray(jout.topk_keys))
        np.testing.assert_array_equal(tout.topk_counts.numpy(),
                                      np.asarray(jout.topk_counts))
        np.testing.assert_allclose(tout.entropies.numpy(),
                                   np.asarray(jout.entropies), **F32_TOL)
    # the flood wrapped the ring and the dict: news on every batch,
    # evictions once the table filled
    assert tpack.evictions == jpack.evictions > 0
    assert tpack.news_rows > 0.8 * 8 * B


def _build(tmp_path, **kw):
    cfg = IngesterConfig(listen_port=0, store_path=str(tmp_path),
                         n_decoders=1, tpu_sketch_window_s=3600.0, **kw)
    return Ingester(cfg, device="cpu")


@pytest.mark.parametrize("kw,want", [
    ({}, flow_suite.FlowSuiteConfig()),
    ({"tpu_sketch_topk_sample_log2": 0},
     flow_suite.FlowSuiteConfig(topk_sample_log2=0)),
    ({"tpu_sketch_topk_sample_log2": 2},
     flow_suite.FlowSuiteConfig(topk_sample_log2=2)),
])
def test_ingester_passes_the_admission_to_the_exporter(tmp_path, kw, want):
    ing = _build(tmp_path, **kw)
    try:
        assert ing.tpu_sketch.cfg == want
    finally:
        ing.close()


def test_server_yaml_key_reaches_the_exporter(tmp_path):
    """The shipped server.yaml with its sketch lane on and the flood's
    key set: it maps onto IngesterConfig and reaches the flow suite the
    exporter runs."""
    text = (REPO / "manifests" / "server.yaml").read_text()
    text = text.replace("  # tpu_sketch_window_s: 1.0",
                        "  tpu_sketch_window_s: 1.0\n"
                        "  tpu_sketch_topk_sample_log2: 0")
    path = tmp_path / "server.yaml"
    path.write_text(text)
    cfg = ingester_config(load_config(str(path))["ingester"])
    assert cfg.tpu_sketch_topk_sample_log2 == 0
    assert cfg.tpu_sketch_window_s == 1.0
    cfg = dataclasses.replace(cfg, listen_port=0, debug_port=None,
                              store_path=str(tmp_path / "store"))
    ing = Ingester(cfg, device="cpu")
    try:
        assert ing.tpu_sketch.cfg == flow_suite.FlowSuiteConfig(
            topk_sample_log2=0)
    finally:
        ing.close()
