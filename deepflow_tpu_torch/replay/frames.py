"""Synthetic raw-frame builders: eth/ipv4 tcp+udp, vlan, simple tunnels.

The replay analogue of the reference's packet-crafting test helpers
(agent/resources/test/ fixture style): hand-built frames that exercise
the batch packet decoder (agent/packet.py) without a capture device.
Used by examples, fixture tests, and the replay CLI.
"""

from __future__ import annotations

import struct

SYN = 0x02
ACK = 0x10
FIN = 0x01
RST = 0x04
PSH = 0x08


def ip4(a: int, b: int, c: int, d: int) -> int:
    """Dotted quad -> the u32 the decoder and schemas carry."""
    return (a << 24) | (b << 16) | (c << 8) | d


def _eth_ipv4(src: int, dst: int, proto: int, l4: bytes,
              vlan: bool = False) -> bytes:
    """eth(+optional 802.1Q) + ipv4(proto) + the given l4 bytes — the
    one header pack every builder shares."""
    eth = b"\x02" * 6 + b"\x04" * 6
    eth += (b"\x81\x00\x00\x01\x08\x00" if vlan else b"\x08\x00")
    ip = struct.pack(">BBHHHBBHII", 0x45, 0, 20 + len(l4), 0, 0, 64,
                     proto, 0, src, dst)
    return eth + ip + l4


def eth_ipv4_tcp(src: int, dst: int, sport: int, dport: int,
                 flags: int = ACK, payload: bytes = b"", seq: int = 0,
                 ack: int = 0, win: int = 8192,
                 vlan: bool = False) -> bytes:
    """One eth(+optional 802.1Q)/ipv4/tcp frame."""
    tcp = struct.pack(">HHIIBBHHH", sport, dport, seq, ack, 0x50, flags,
                      win, 0, 0) + payload
    return _eth_ipv4(src, dst, 6, tcp, vlan=vlan)


def eth_ipv4_udp(src: int, dst: int, sport: int, dport: int,
                 payload: bytes = b"") -> bytes:
    """One eth/ipv4/udp frame."""
    udp = struct.pack(">HHHH", sport, dport, 8 + len(payload), 0) + payload
    return _eth_ipv4(src, dst, 17, udp)


def eth_ipv6_tcp(src16: bytes, dst16: bytes, sport: int, dport: int,
                 flags: int = ACK, payload: bytes = b"",
                 seq: int = 0) -> bytes:
    """One eth/ipv6/tcp frame (fixed 40-byte v6 header, 16-byte
    addresses)."""
    tcp = struct.pack(">HHIIBBHHH", sport, dport, seq, 0, 0x50, flags,
                      8192, 0, 0) + payload
    ip6 = struct.pack(">IHBB", 0x60000000, len(tcp), 6, 64) \
        + src16 + dst16
    return b"\x02" * 6 + b"\x04" * 6 + b"\x86\xdd" + ip6 + tcp


def vxlan(outer_src: int, outer_dst: int, inner_frame: bytes,
          vni: int = 123) -> bytes:
    """Wrap an inner frame in vxlan/udp/ipv4 (decap tested in
    agent/packet.py)."""
    head = struct.pack(">BBHI", 0x08, 0, 0, vni << 8)
    return eth_ipv4_udp(outer_src, outer_dst, 5555, 4789,
                        head + inner_frame)


def gre_teb(outer_src: int, outer_dst: int, inner_frame: bytes,
            key: int | None = None) -> bytes:
    """Wrap an inner eth frame in GRE transparent-ethernet-bridging
    (proto 0x6558) over ipv4, with an optional GRE key."""
    if key is None:
        gre = struct.pack(">HH", 0, 0x6558)
    else:
        gre = struct.pack(">HHI", 0x2000, 0x6558, key)
    return _eth_ipv4(outer_src, outer_dst, 47, gre + inner_frame)


def erspan_i(outer_src: int, outer_dst: int, inner_frame: bytes) -> bytes:
    """ERSPAN type I: bare GRE proto 0x88BE (no S flag, no ERSPAN
    header) directly wrapping the inner eth frame."""
    return _eth_ipv4(outer_src, outer_dst, 47,
                     struct.pack(">HH", 0, 0x88BE) + inner_frame)


def erspan_ii(outer_src: int, outer_dst: int, inner_frame: bytes,
              span_id: int = 5) -> bytes:
    """ERSPAN type II: GRE (proto 0x88BE, S flag) + 8-byte ERSPAN
    header + inner eth frame."""
    gre = struct.pack(">HHI", 0x1000, 0x88BE, 7)        # S flag + seq
    ers = struct.pack(">HHI", (1 << 12), span_id, 0)    # ver 1 (type II)
    return _eth_ipv4(outer_src, outer_dst, 47, gre + ers + inner_frame)
