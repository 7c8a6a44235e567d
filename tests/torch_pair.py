"""A harness for the port's ingest tests: the JAX package's `Ingester`
and the port's `Ingester(device="cpu")` built from the same config
fields, each driven with the same frames over loopback TCP, one after
the other, and read back after `close()` (every writer flushed, the tag
dictionaries persisted).

`drive` sends each stage's frames and waits for the stage's `done`
predicate before the next stage, so rows that draw from the process-wide
row-id counter get the same `_id`s in both packages (both counters
restart at 1). `tables` scans every table of a store root with the JAX
package's Store, sorted row by row (integer columns first), so rows that
two pipeline threads appended in either order compare equal.
"""

import os
import socket
import time

import numpy as np

from deepflow_tpu.pipelines import flow_log as jflow_log
from deepflow_tpu.pipelines.ingester import Ingester as JIngester
from deepflow_tpu.pipelines.ingester import IngesterConfig as JConfig
from deepflow_tpu.store import db as jdb
from deepflow_tpu_torch.pipelines import Ingester, IngesterConfig
from deepflow_tpu_torch.pipelines import flow_log as tflow_log

BASE = dict(listen_port=0, n_decoders=1, timeline_sample_s=0)


def wait(fn, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not fn():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.01)


def build(package, root, **kw):
    """An ingester of `package` ("jax" or "port") over `root`."""
    cfg = {**BASE, "store_path": root, **kw}
    if package == "jax":
        jflow_log._ID_NEXT[0] = 1
        return JIngester(JConfig(**cfg))
    tflow_log._ID_NEXT[0] = 1
    return Ingester(IngesterConfig(**cfg), device="cpu")


def drive(ing, stages, port=None):
    """Send each (frames, done) stage over one connection; `done(ing)`
    must hold before the next stage is sent."""
    s = socket.create_connection(("127.0.0.1", port or ing.port))
    try:
        for frames, done in stages:
            for f in frames:
                s.sendall(f)
            wait(lambda: done(ing), "a stage to land")
    finally:
        s.close()


def decoder(ing, stream):
    return next(d for d in ing.flow_log.decoders if d.stream == stream)


def offered(ing, stream):
    """Rows a flow_log stream has finished with (stamped and offered to
    its throttler, or written straight through)."""
    d = decoder(ing, stream)
    return d.records if d.throttler is None else d.throttler.in_count


def run(package, root, stages, probe=None, **kw):
    """Build, start, drive, probe (before close), close; returns
    (receiver counters, probe result, ingester)."""
    ing = build(package, root, **kw)
    ing.start()
    try:
        drive(ing, stages)
        got = probe(ing) if probe is not None else None
        rc = ing.receiver.counters()
    finally:
        ing.close()
    return rc, got, ing


def tables(root):
    """{(db, table): columns sorted row by row} of every table under a
    store root, scanned with the JAX package's Store."""
    store = jdb.Store(root)
    out = {}
    for db, name in store.tables():
        cols = store.table(db, name).scan()
        if not cols or not len(next(iter(cols.values()))):
            out[(db, name)] = {}
            continue
        keys = sorted(cols, key=lambda k: (cols[k].dtype.kind == "f", k))
        order = np.lexsort([cols[k] for k in reversed(keys)])
        out[(db, name)] = {k: cols[k][order] for k in keys}
    return out


def assert_tables_equal(t, j, skip=(), loose=()):
    """Every table of both roots: the same tables, the same columns and
    dtypes, the same rows (columns in `skip` left out). The float columns
    of the tables in `loose` (device readouts: entropies, quantiles) agree
    within rtol 1e-5; every other column is exact."""
    assert sorted(t) == sorted(j)
    for key in j:
        a, b = t[key], j[key]
        assert sorted(a) == sorted(b), key
        for col in b:
            if col in skip:
                continue
            assert a[col].dtype == b[col].dtype, (key, col)
            if key in loose and b[col].dtype.kind == "f":
                np.testing.assert_allclose(a[col], b[col], rtol=1e-5,
                                           atol=1e-6, err_msg=f"{key} {col}")
                continue
            np.testing.assert_array_equal(a[col], b[col],
                                          err_msg=f"{key} {col}")


def dict_lines(root):
    """Each persisted tag dictionary's entries, sorted."""
    d = os.path.join(root, "flow_tag")
    if not os.path.isdir(d):
        return {}
    return {name: sorted(open(os.path.join(d, name)).read().splitlines())
            for name in sorted(os.listdir(d))}


def files(root):
    """{relative path: bytes} of every file under a directory."""
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out
