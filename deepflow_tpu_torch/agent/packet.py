"""Vectorized packet header decode: raw frames -> MetaPacket columns.

A copy of the JAX package's `agent/packet.py` (numpy only: the decode
runs on the host in both packages).

Reference: agent/src/common/meta_packet.rs builds one MetaPacket struct
per packet in the dispatcher hot loop. Here a whole capture batch
decodes at once: headers are gathered into a padded [n, 64] byte matrix
and every field (ethertype, 5-tuple, flags, lengths) is sliced out with
numpy fancy indexing — no per-packet Python. Handles Ethernet(+802.1Q),
IPv4, TCP/UDP/ICMP, and VXLAN decapsulation (one recursion level, the
common overlay case; reference: agent/src/common/decapsulate.rs).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

ETH_IPV4 = 0x0800
ETH_IPV6 = 0x86DD
ETH_VLAN = 0x8100
PROTO_TCP = 6
PROTO_UDP = 17
PROTO_GRE = 47
PROTO_ICMP = 1
VXLAN_PORT = 4789

# enough for eth+vlan+ipv6(40)+tcp(20)+options slack; v4 with options
# still fits with more slack than the old 64
HDR_BYTES = 96

# tcp flag bits (reference: flow_state.rs)
FIN, SYN, RST, PSH, ACK = 0x01, 0x02, 0x04, 0x08, 0x10


def _headers_matrix(frames: List[bytes]) -> Tuple[np.ndarray, np.ndarray]:
    """[n, HDR_BYTES] uint8 padded header bytes + [n] original lengths."""
    n = len(frames)
    mat = np.zeros((n, HDR_BYTES), np.uint8)
    lens = np.zeros(n, np.int32)
    for i, f in enumerate(frames):
        lens[i] = len(f)
        h = f[:HDR_BYTES]
        mat[i, :len(h)] = np.frombuffer(h, np.uint8)
    return mat, lens


def _be16(mat: np.ndarray, off: np.ndarray) -> np.ndarray:
    rows = np.arange(mat.shape[0])
    return (mat[rows, off].astype(np.uint32) << 8) | mat[rows, off + 1]


def _be32(mat: np.ndarray, off: np.ndarray) -> np.ndarray:
    rows = np.arange(mat.shape[0])
    out = np.zeros(mat.shape[0], np.uint32)
    for k in range(4):
        out = (out << np.uint32(8)) | mat[rows, off + k]
    return out


def _fold16_rows(sub: np.ndarray, off: int) -> np.ndarray:
    """Vectorized store.dict_store.fold_ipv6 over the rows of `sub`
    (byte-for-byte identical, asserted in tests): FNV-1a over 16 bytes,
    confined to class E so folded v6 keys never collide with real v4
    ranges. Callers pass only the v6 rows — cost scales with v6 count,
    not batch size."""
    n = sub.shape[0]
    rows = np.arange(n)
    h = np.full(n, 0x811C9DC5, np.uint32)
    with np.errstate(over="ignore"):
        for k in range(16):
            h = (h ^ sub[rows, off + k]) * np.uint32(0x01000193)
    return h | np.uint32(0xF0000000)


def decode_packets(frames: List[bytes],
                   timestamps_ns: Optional[np.ndarray] = None,
                   decap_vxlan: bool = True) -> Dict[str, np.ndarray]:
    """Decode a batch of raw Ethernet frames into MetaPacket columns.

    Returns columns: valid(bool), ip_src, ip_dst, port_src, port_dst,
    proto, tcp_flags, pkt_len, payload_off, payload_len, timestamp_ns,
    tunneled(bool). IPv4 and IPv6 parse (v6 addresses fold to u32 via
    the system-wide FNV-1a, matching the enrich key space); anything
    else comes back valid=False (counted, not dropped silently — the
    caller keeps the mask).
    """
    n = len(frames)
    if timestamps_ns is None:
        timestamps_ns = np.zeros(n, np.uint64)
    mat, lens = _headers_matrix(frames)
    rows = np.arange(n)

    eth_type = _be16(mat, np.full(n, 12))
    l3_off = np.full(n, 14)
    vlan = eth_type == ETH_VLAN
    vlan_id = np.zeros(n, np.uint32)
    if vlan.any():
        # 802.1Q: real ethertype 4 bytes later
        et2 = _be16(mat, np.full(n, 16))
        vlan_id = np.where(vlan, _be16(mat, np.full(n, 14)) & 0x0FFF, 0)
        eth_type = np.where(vlan, et2, eth_type)
        l3_off = np.where(vlan, 18, l3_off)

    # MACs: 6 bytes each, vectorized horner over the header matrix
    mac_dst = np.zeros(n, np.uint64)
    mac_src = np.zeros(n, np.uint64)
    for k in range(6):
        mac_dst = (mac_dst << np.uint64(8)) | mat[rows, k]
        mac_src = (mac_src << np.uint64(8)) | mat[rows, 6 + k]

    is4 = (eth_type == ETH_IPV4) & (lens >= l3_off + 20)
    is6 = (eth_type == ETH_IPV6) & (lens >= l3_off + 40)
    valid = is4 | is6
    ihl = (mat[rows, l3_off] & 0x0F).astype(np.int32) * 4
    valid &= ~is4 | (ihl >= 20)  # v4 IHL < 5 is malformed
    # v6: fixed 40-byte header. A next-header value naming an EXTENSION
    # header (hop-by-hop/routing/fragment/ESP/AH/dest-opts) would need a
    # chain walk to find the real l4; those packets come back
    # valid=False (counted, not mis-parsed — proto 0 must never alias
    # the hop-by-hop header). Final protocols (TCP/UDP/ICMPv6/...)
    # parse with the l4 header at the fixed 40-byte offset.
    proto = np.where(is6, mat[rows, l3_off + 6],
                     mat[rows, l3_off + 9]).astype(np.uint32)
    _V6_EXT = (0, 43, 44, 50, 51, 60, 135, 139, 140)  # incl. Mobility/HIP/Shim6
    ext6 = is6 & np.isin(proto, _V6_EXT)
    valid &= ~ext6
    # v6 addresses fold to u32 exactly like the enrich layer's FNV-1a
    # fold (enrich/platform_data.py key packing), so platform joins on
    # folded v6 keys agree with capture
    ip_src = _be32(mat, l3_off + 12)
    ip_dst = _be32(mat, l3_off + 16)
    if is6.any():
        i6 = np.nonzero(is6)[0]
        # one fancy-index gather of each v6 row's 40 l3 header bytes
        # (l3_off varies per row with vlan) — no per-packet Python
        sub = mat[i6[:, None], l3_off[i6][:, None] + np.arange(40)]
        ip_src[i6] = _fold16_rows(sub, 8)
        ip_dst[i6] = _fold16_rows(sub, 24)
    l4_off = np.where(is6, l3_off + 40, l3_off + ihl)
    # l4 header must sit inside the sliced header matrix — clamped reads
    # past it would fabricate ports/flags from IP option bytes
    valid &= l4_off + 14 <= HDR_BYTES

    is_l4 = valid & ((proto == PROTO_TCP) | (proto == PROTO_UDP))
    port_src = np.where(is_l4, _be16(mat, np.minimum(l4_off, HDR_BYTES - 2)),
                        0).astype(np.uint32)
    port_dst = np.where(is_l4,
                        _be16(mat, np.minimum(l4_off + 2, HDR_BYTES - 2)),
                        0).astype(np.uint32)

    is_tcp = valid & (proto == PROTO_TCP)
    doff = (mat[rows, np.minimum(l4_off + 12, HDR_BYTES - 1)] >> 4) \
        .astype(np.int32) * 4
    tcp_flags = np.where(
        is_tcp, mat[rows, np.minimum(l4_off + 13, HDR_BYTES - 1)],
        0).astype(np.uint32)
    tcp_seq = np.where(is_tcp,
                       _be32(mat, np.minimum(l4_off + 4, HDR_BYTES - 4)),
                       0).astype(np.uint32)
    tcp_ack = np.where(is_tcp,
                       _be32(mat, np.minimum(l4_off + 8, HDR_BYTES - 4)),
                       0).astype(np.uint32)
    tcp_win = np.where(is_tcp,
                       _be16(mat, np.minimum(l4_off + 14, HDR_BYTES - 2)),
                       0).astype(np.uint32)
    payload_off = np.where(is_tcp, l4_off + doff,
                           np.where(proto == PROTO_UDP, l4_off + 8, l4_off))
    payload_len = np.maximum(lens - payload_off, 0)

    cols = {
        "valid": valid,
        "ip_src": ip_src, "ip_dst": ip_dst,
        "port_src": port_src, "port_dst": port_dst,
        "proto": np.where(valid, proto, 0).astype(np.uint32),
        "tcp_flags": tcp_flags,
        "tcp_seq": tcp_seq,
        "tcp_ack": tcp_ack,
        "tcp_win": tcp_win,
        "pkt_len": lens.astype(np.uint32),
        "payload_off": payload_off.astype(np.int32),
        "payload_len": payload_len.astype(np.int32),
        "timestamp_ns": np.asarray(timestamps_ns, np.uint64),
        "tunneled": np.zeros(n, np.bool_),
        "mac_src": mac_src, "mac_dst": mac_dst,
        "vlan_id": vlan_id,
        # 4 or 6 (0 when invalid): v6 ip columns are FNV folds, so any
        # consumer doing v4-prefix math (policy CIDR rules, CIDR joins)
        # must gate on this
        "ip_version": np.where(is6, 6,
                               np.where(is4, 4, 0)).astype(np.uint8),
    }

    if decap_vxlan:
        vx = (cols["valid"] & (cols["proto"] == PROTO_UDP)
              & (cols["port_dst"] == VXLAN_PORT)
              & (payload_len >= 8 + 14))
        if vx.any():
            # strip outer eth/ip/udp + vxlan(8): re-decode the inner frame
            inner_frames = []
            idxs = np.nonzero(vx)[0]
            for i in idxs:
                off = int(payload_off[i]) + 8
                inner_frames.append(frames[i][off:])
            inner = decode_packets(inner_frames,
                                   timestamps_ns[idxs], decap_vxlan=False)
            # inner MACs replace the outer VTEP MACs: the flow the ip
            # columns now describe belongs to the overlay VMs, and
            # mirror-mode MAC filtering / tap_side orientation must see
            # the same layer
            for name in ("valid", "ip_src", "ip_dst", "port_src",
                         "port_dst", "proto", "tcp_flags", "tcp_seq",
                         "tcp_ack", "tcp_win",
                         "mac_src", "mac_dst", "ip_version"):
                cols[name][idxs] = inner[name]
            # payload offsets are relative to the inner frame start
            cols["payload_off"][idxs] = inner["payload_off"] + \
                payload_off[idxs].astype(np.int32) + 8
            cols["payload_len"][idxs] = inner["payload_len"]
            cols["tunneled"][idxs] = True

        # GRE (proto 47) and ERSPAN-over-GRE (reference:
        # common/decapsulate.rs TunnelType::{Gre, ErspanOrTeb}). The GRE
        # header is 4 bytes + 4 per C/K/S flag; protocol 0x6558
        # (transparent ethernet) and 0x88BE/0x22EB (ERSPAN I-II/III,
        # which add an 8/12-byte ERSPAN header before the inner eth)
        # carry a full inner frame we can re-decode.
        # ~tunneled: a row the VXLAN pass already rewrote carries INNER
        # columns with OUTER offsets — re-examining it here would read
        # GRE fields out of the vxlan header
        gre = cols["valid"] & (cols["proto"] == PROTO_GRE) \
            & ~cols["tunneled"]
        if gre.any():
            idxs, inner_frames, kept = np.nonzero(gre)[0], [], []
            for i in idxs:
                off = int(payload_off[i])
                f = frames[i]
                if off + 4 > len(f):
                    continue
                s_flag = (f[off] >> 4) & 1
                gproto = (f[off + 2] << 8) | f[off + 3]
                hdr = 4 + 4 * ((f[off] >> 7) & 1) \
                    + 4 * ((f[off] >> 5) & 1) + 4 * s_flag
                if gproto == 0x6558:              # TEB: inner eth
                    inner_off = off + hdr
                elif gproto == 0x88BE:
                    # ERSPAN I has NO header and no S flag; II has the S
                    # flag and an 8-byte header (type I vs II is exactly
                    # this bit, decapsulate.rs erspan handling)
                    inner_off = off + hdr + (8 if s_flag else 0)
                elif gproto == 0x22EB:            # ERSPAN III: 12B header
                    if off + hdr + 12 > len(f):
                        continue
                    inner_off = off + hdr + 12
                    if f[off + hdr + 11] & 0x01:  # O bit: 8B subheader
                        inner_off += 8
                else:
                    continue                      # routed GRE: no inner eth
                if inner_off + 14 > len(f):
                    continue
                kept.append((i, inner_off))
                inner_frames.append(f[inner_off:])
            if kept:
                idxs = np.asarray([i for i, _ in kept])
                inner = decode_packets(inner_frames, timestamps_ns[idxs],
                                       decap_vxlan=False)
                # a bridged inner frame can legitimately be non-IP
                # (ARP/LLDP ride TEB): those keep the valid OUTER flow
                # row instead of being overwritten with invalid columns
                ok = inner["valid"]
                if ok.any():
                    sub = idxs[ok]
                    for name in ("valid", "ip_src", "ip_dst", "port_src",
                                 "port_dst", "proto", "tcp_flags",
                                 "tcp_seq", "tcp_ack", "tcp_win",
                                 "mac_src", "mac_dst", "ip_version"):
                        cols[name][sub] = inner[name][ok]
                    offs = np.asarray([o for _, o in kept],
                                      np.int32)[ok]
                    cols["payload_off"][sub] = \
                        inner["payload_off"][ok] + offs
                    cols["payload_len"][sub] = inner["payload_len"][ok]
                    cols["tunneled"][sub] = True
    return cols
