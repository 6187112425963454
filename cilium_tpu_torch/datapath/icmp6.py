"""ICMPv6/NDP reply synthesis (bpf/lib/icmp6.h analog).

Copy of ``cilium_tpu/datapath/icmp6.py``.  The datapath stage
(pipeline.full_datapath_step6 stage 1.5) decides
WHICH packets are answered locally (events ICMP6_NS_REPLY /
ICMP6_ECHO_REPLY); this module builds the actual reply bytes the
responder sends — the host-side counterpart of icmp6.h's in-place
packet rewrite:

- ``ndisc_advertisement``: NS -> NA with router=1, solicited=1,
  override=0 and a target-link-layer-address option carrying the
  router MAC (send_icmp6_ndisc_adv:149-203);
- ``echo_reply``: echo request -> echo reply with src/dst swapped
  (__icmp6_send_echo_reply:84-137);
- ``icmp6_checksum``: full pseudo-header checksum
  (compute_icmp6_csum:204).
"""

from __future__ import annotations

import struct
from typing import Sequence


def _words_to_bytes(words: Sequence[int]) -> bytes:
    return b"".join(struct.pack(">I", w & 0xFFFFFFFF) for w in words)


def icmp6_checksum(src_words: Sequence[int], dst_words: Sequence[int],
                   icmp6_payload: bytes) -> int:
    """ICMPv6 checksum over the IPv6 pseudo-header + message
    (RFC 4443 2.3; compute_icmp6_csum analog)."""
    pseudo = (_words_to_bytes(src_words) + _words_to_bytes(dst_words) +
              struct.pack(">I", len(icmp6_payload)) +
              b"\x00\x00\x00\x3a")
    data = pseudo + icmp6_payload
    if len(data) % 2:
        data += b"\x00"
    total = sum(struct.unpack(f">{len(data) // 2}H", data))
    while total >> 16:
        total = (total & 0xFFFF) + (total >> 16)
    return (~total) & 0xFFFF


def _ipv6_header(src_words, dst_words, payload_len: int) -> bytes:
    return (b"\x60\x00\x00\x00" +
            struct.pack(">HBB", payload_len, 58, 255) +
            _words_to_bytes(src_words) + _words_to_bytes(dst_words))


def ndisc_advertisement(router_words: Sequence[int],
                        solicitor_words: Sequence[int],
                        target_words: Sequence[int],
                        router_mac: bytes) -> bytes:
    """Full IPv6+ICMPv6 neighbour advertisement answering an NS.

    Reply goes router -> solicitor; flags router|solicited (the
    reference sets icmp6_router=1, icmp6_solicited=1, override=0);
    option type 2 (target link-layer address) carries the router MAC.
    """
    assert len(router_mac) == 6
    flags = 0xC0000000  # router | solicited
    body = (struct.pack(">BBH", 136, 0, 0) +     # type, code, csum=0
            struct.pack(">I", flags) +
            _words_to_bytes(target_words) +
            b"\x02\x01" + router_mac)            # TLLA option
    csum = icmp6_checksum(router_words, solicitor_words, body)
    body = body[:2] + struct.pack(">H", csum) + body[4:]
    return _ipv6_header(router_words, solicitor_words,
                        len(body)) + body


def echo_reply(router_words: Sequence[int],
               requester_words: Sequence[int],
               ident: int, seq: int, payload: bytes = b"") -> bytes:
    """Full IPv6+ICMPv6 echo reply for a request to the router."""
    body = (struct.pack(">BBH", 129, 0, 0) +
            struct.pack(">HH", ident & 0xFFFF, seq & 0xFFFF) + payload)
    csum = icmp6_checksum(router_words, requester_words, body)
    body = body[:2] + struct.pack(">H", csum) + body[4:]
    return _ipv6_header(router_words, requester_words,
                        len(body)) + body


def parse_icmp6(packet: bytes) -> dict:
    """Parse an IPv6+ICMPv6 packet built by this module (test/probe
    side): returns {src_words, dst_words, type, code, checksum_ok,
    target_words?/ident?/seq?, tlla?}."""
    assert len(packet) >= 48 and packet[6] == 58
    src = list(struct.unpack(">4I", packet[8:24]))
    dst = list(struct.unpack(">4I", packet[24:40]))
    body = packet[40:]
    typ, code, csum = struct.unpack(">BBH", body[:4])
    zeroed = body[:2] + b"\x00\x00" + body[4:]
    out = {"src_words": src, "dst_words": dst, "type": typ,
           "code": code,
           "checksum_ok": icmp6_checksum(src, dst, zeroed) == csum}
    if typ in (135, 136):
        out["target_words"] = list(struct.unpack(">4I", body[8:24]))
        if len(body) >= 32 and body[24] == 2:
            out["tlla"] = body[26:32]
    elif typ in (128, 129):
        out["ident"], out["seq"] = struct.unpack(">HH", body[4:8])
    return out
