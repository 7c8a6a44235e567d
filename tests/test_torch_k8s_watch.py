"""The port's Kubernetes apiserver list/watch client
(`deepflow_tpu_torch/agent/k8s_watch.py`) against the JAX package's, on
the CPU.

Both packages' `ApiWatcher`s watch one fake apiserver at the same time
(chip_smoke's `FakeApiserver`, the one phase 20 runs at full size: paged
LISTs, chunked WATCH streams, a 410 Expired per client on demand; each
watcher its own bearer token): after the LIST, after ADDED, MODIFIED and
DELETED events and after the 410's relist, the two snapshots and
counters must be equal. The JAX package's own watcher tests then run
against the port (`torch_ctl_pair.adopt_reference_tests`).
"""

import time

import numpy as np

import chip_smoke
import torch_ctl_pair as cp

from deepflow_tpu.agent import k8s_watch as jk8s
from deepflow_tpu_torch.agent import k8s_watch as tk8s

RESOURCES = ("pods", "nodes", "namespaces", "services")


def _objects(rng, n_pods=40):
    ips = rng.choice(1 << 16, n_pods, replace=False)
    return {
        "nodes": [chip_smoke.k8s_obj("nodes", f"node-{i}", 1,
                                     ip=f"10.255.{i}.1") for i in range(4)],
        "namespaces": [chip_smoke.k8s_obj("namespaces", f"ns-{i}", 1)
                       for i in range(3)],
        "pods": [chip_smoke.k8s_obj("pods", f"pod-{k:03d}", 1,
                                    ns=f"ns-{k % 3}",
                                    ip=f"172.16.{ips[k] >> 8}.{ips[k] & 255}",
                                    node=f"node-{k % 4}")
                 for k in range(n_pods)],
        "services": [chip_smoke.k8s_obj("services", f"svc-{k}", 1,
                                        ns="ns-0", ip=f"10.96.0.{k + 1}")
                     for k in range(6)]}


def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def _counters(w):
    c = w.counters()
    return {k: c[k] for k in ("lists", "watch_events", "relists_410",
                              "errors", "cached")}


def test_both_watchers_equal_through_list_watch_and_relist():
    rng = np.random.default_rng(0x8A)
    objects = _objects(rng)
    api = chip_smoke.FakeApiserver(objects, hold_s=0.3)
    ws = [mod.ApiWatcher(api.url, resources=RESOURCES, token=tok,
                         watch_timeout_s=5, backoff_s=0.05, list_limit=7)
          for mod, tok in ((jk8s, "jax"), (tk8s, "port"))]
    try:
        for w in ws:
            w.start()
        assert _wait(lambda: all(w.lists == len(RESOURCES) for w in ws))
        snaps = [w.snapshot() for w in ws]
        assert snaps[1] == snaps[0]
        assert sum(r["type"] == "pod" for r in snaps[0]) == 40
        assert {r["type"] for r in snaps[0]} == {"pod", "pod_node",
                                                 "pod_ns", "service"}
        # events: an add, a change of a pod's address, a delete, a new
        # service; both caches apply all four
        api.add("pods", chip_smoke.k8s_obj("pods", "pod-new", 0, ns="ns-1",
                                           ip="172.16.250.1", node="node-2"))
        moved = dict(objects["pods"][5])
        moved["status"] = {"podIP": "172.16.251.9"}
        api.add("pods", moved)          # a known uid: MODIFIED
        api.delete("pods", objects["pods"][7]["metadata"]["uid"])
        api.add("services", chip_smoke.k8s_obj("services", "svc-new", 0,
                                               ns="ns-0", ip="10.96.1.1"))
        assert _wait(lambda: all(w.watch_events == 4 for w in ws))
        snaps = [w.snapshot() for w in ws]
        assert snaps[1] == snaps[0]
        names = {r["name"]: r for r in snaps[0]}
        assert "pod-new" in names and "pod-007" not in names
        assert names["pod-005"]["ip"] == "172.16.251.9"
        # 410 Expired on each watcher's next watch of each resource
        api.expire()
        assert _wait(lambda: all(w.relists_410 == len(RESOURCES)
                                 and w.lists == 2 * len(RESOURCES)
                                 for w in ws))
        assert ws[1].snapshot() == ws[0].snapshot() == snaps[0]
        assert _counters(ws[1]) == _counters(ws[0])
        assert _counters(ws[0])["errors"] == 0
    finally:
        for w in ws:
            w.close()
        api.close()
    # every list paged (7 a page) and was counted once at the server
    assert api.lists == {r: 4 for r in RESOURCES}


def test_fake_apiserver_pages_and_versions():
    """The fake's LIST pages hold every object once at one
    resourceVersion; its watch from that version replays later events."""
    import json
    import urllib.request
    rng = np.random.default_rng(0x8B)
    api = chip_smoke.FakeApiserver(_objects(rng, 23), hold_s=0.2)
    try:
        seen, cont, rvs = [], None, set()
        while True:
            q = "limit=5" + (f"&continue={cont}" if cont else "")
            with urllib.request.urlopen(f"{api.url}/api/v1/pods?{q}") as r:
                body = json.load(r)
            seen += [o["metadata"]["name"] for o in body["items"]]
            rvs.add(body["metadata"]["resourceVersion"])
            cont = body["metadata"].get("continue")
            if not cont:
                break
        assert sorted(seen) == [f"pod-{k:03d}" for k in range(23)]
        assert rvs == {"1"} and api.lists["pods"] == 1
        api.delete("pods", "uid-pods-pod-003")
        with urllib.request.urlopen(
                f"{api.url}/api/v1/pods?watch=1&resourceVersion=1") as r:
            events = [json.loads(x) for x in r.read().splitlines() if x]
        assert [(e["type"], e["object"]["metadata"]["name"])
                for e in events] == [("DELETED", "pod-003")]
    finally:
        api.close()


# -- the JAX package's watcher tests, on the port -----------------------------
cp.adopt_reference_tests(globals(), cp.TESTS / "test_k8s_watch.py")
