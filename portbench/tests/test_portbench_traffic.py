"""The traffic generator: seeded, cycled, and its unique rows stay new."""

import numpy as np
import pytest

from traffic.generator import load_mix, make_bank, zipf_ranks


@pytest.mark.parametrize("mix", ["zipf_steady", "syn_flood", "red_services"])
def test_same_seed_same_bank(mix, small_mix):
    a = make_bank(mix, 2**31 + 5, small_mix(mix))
    b = make_bank(mix, 2**31 + 5, small_mix(mix))
    c = make_bank(mix, 2**31 + 6, small_mix(mix))
    assert a.columns.keys() == b.columns.keys()
    for k in a.columns:
        np.testing.assert_array_equal(a.columns[k], b.columns[k])
    assert any(not np.array_equal(a.columns[k], c.columns[k])
               for k in a.columns)


@pytest.mark.parametrize("mix", ["zipf_steady", "syn_flood", "red_services"])
def test_chunks_are_the_records(mix, small_mix):
    bank = make_bank(mix, 9, small_mix(mix))
    n = bank.chunk_rows
    i = 2 * bank.n_chunks + 3                    # the third cycle
    chunk = bank.chunk(i)
    rec = bank.records(i * n - 7, (i + 1) * n)
    for k in chunk:
        np.testing.assert_array_equal(rec[k][7:], chunk[k])
    assert len(chunk["ip_dst"]) == n


def _tuples(cols):
    return np.stack([cols[k].astype(np.uint64) for k in
                     ("ip_src", "port_src", "ip_dst", "port_dst",
                      "proto")], axis=1)


def test_flood_rows_stay_new_across_cycles(small_mix):
    mix = small_mix("syn_flood", 1 << 15)
    bank = make_bank("syn_flood", 11, mix)
    cols = bank.records(0, 4 * bank.n_records)   # four cycles of the bank
    victim = (cols["ip_dst"] == (172 << 24 | 16 << 16 | 190 << 8 | 239)) \
        & (cols["port_dst"] == 80) & (cols["packet_tx"] == 96)
    attack = _tuples(cols)[victim]
    assert victim.mean() == pytest.approx(0.9, abs=0.02)
    assert len(np.unique(attack, axis=0)) == len(attack)
    src = cols["ip_src"][victim]
    assert (src >> 20 == 11 << 4).all()          # 11.0.0.0/12
    ports = cols["port_src"][victim]
    assert ports.min() >= 1024 and ports.max() <= 65535


def test_fresh_rows_stay_new_pool_rows_repeat(small_mix):
    bank = make_bank("zipf_steady", 12, small_mix("zipf_steady", 1 << 15))
    one = _tuples(bank.records(0, bank.n_records))
    two = _tuples(bank.records(bank.n_records, 2 * bank.n_records))
    same = (one == two).all(axis=1)
    assert same.mean() == pytest.approx(0.99, abs=0.01)
    fresh = ~same
    assert len(np.unique(np.concatenate([one[fresh], two[fresh]]),
                         axis=0)) == 2 * fresh.sum()


def test_zipf_is_truncated_not_clipped():
    rng = np.random.default_rng(0)
    r = zipf_ranks(rng, 1.1, 1000, 200_000)
    assert r.min() == 0 and r.max() <= 999
    counts = np.bincount(r, minlength=1000)
    # no pile-up on the last rank; rank 1 about 2^1.1 times rank 2
    assert counts[-1] < counts[-2] * 3
    assert counts[0] / counts[1] == pytest.approx(2 ** 1.1, rel=0.05)


def test_red_mix_shares():
    mix = load_mix("red_services")
    mix["bank_records"] = 1 << 19
    cols = make_bank("red_services", 3, mix).columns
    share = {p["protocol"]: p["share"] for p in mix["protocols"]}
    for code, want in share.items():
        assert (cols["protocol"] == code).mean() == pytest.approx(
            want, abs=0.03)
    s = cols["status"].astype(np.int64)
    err = (s >= 400) | ((s > 0) & (s < 100))
    assert err.mean() == pytest.approx(0.03, abs=0.003)
    assert np.median(cols["rrt_us"]) == pytest.approx(2000, rel=0.3)
    assert cols["rrt_us"].min() >= 1
