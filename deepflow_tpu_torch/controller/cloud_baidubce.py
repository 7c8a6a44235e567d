"""Baidu Cloud (BCE) client: the bce-auth-v1 protocol from scratch.

Reference: server/controller/cloud/baidubce/ — vpc.go/network.go/
vm.go link the official BCE SDK against "bcc."+endpoint and walk
ListVpcs/ListSubnets/ListInstances with Marker/NextMarker pagination
(vpc.go:41-53). The SDK's wire protocol, implemented directly here
(the repo-wide no-vendored-SDK discipline):

- header auth, SIXTH dialect: `Authorization: bce-auth-v1/{ak}/
  {timestamp}/{expiry}/{signedHeaders}/{signature}` where the signing
  key is hex(HMAC-SHA256(sk, authStringPrefix)) — a DERIVED-KEY
  scheme like TC3 but hex-encoded and single-stage — and the
  signature is hex(HMAC-SHA256(signingKey, canonicalRequest)) over
  METHOD\\nURI\\nQUERY\\nCANONICAL_HEADERS (signed headers
  lowercased, uri-encoded, newline-joined);
- marker pagination: follow nextMarker while isTruncated;
- JSON shapes: vpcs {vpcId,name,cidr}, subnets {subnetId,name,cidr,
  vpcId,zoneName}, instances {id,name,internalIp,zoneName,vpcId}.

Emits the same normalized region/az/vpc/subnet/vm rows as the rest.

The port's own copy of the JAX package's `controller/cloud_baidubce.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import time
import urllib.parse
import urllib.request
from typing import Dict, List, Optional

from deepflow_tpu_torch.controller.cloud import (ResourceBuilder,
                                                 add_vm_public_addresses)
from deepflow_tpu_torch.controller.model import Resource

PAGE_KEYS = 1000
_EXPIRY_S = 1800


def _uri_encode(s: str, slash_ok: bool = False) -> str:
    return urllib.parse.quote(s, safe="/" if slash_ok else "")


def bce_authorization(ak: str, sk: str, method: str, path: str,
                      query: Dict[str, str], host: str,
                      timestamp: Optional[str] = None) -> str:
    """The documented bce-auth-v1 construction; `host` is the single
    signed header (what the SDK signs by default)."""
    ts = timestamp or time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                    time.gmtime())
    prefix = f"bce-auth-v1/{ak}/{ts}/{_EXPIRY_S}"
    signing_key = hmac.new(sk.encode(), prefix.encode(),
                           hashlib.sha256).hexdigest()
    canonical_query = "&".join(
        f"{_uri_encode(k)}={_uri_encode(str(v))}"
        for k, v in sorted(query.items()))
    canonical_headers = f"host:{_uri_encode(host)}"
    canonical = (f"{method}\n{_uri_encode(path, slash_ok=True)}\n"
                 f"{canonical_query}\n{canonical_headers}")
    sig = hmac.new(signing_key.encode(), canonical.encode(),
                   hashlib.sha256).hexdigest()
    return f"{prefix}/host/{sig}"


class BaiduBcePlatform:
    """Same duck type as the other vendor clients; endpoint is the
    region endpoint (the reference's b.endpoint, e.g. "bj.baidubce
    .com"), with the bcc host prefix applied like the SDK does."""

    def __init__(self, domain: str, secret_id: str, secret_key: str,
                 endpoint: str, region_name: str = "baidu",
                 scheme: str = "https",
                 bcc_host: Optional[str] = None) -> None:
        self.domain = domain
        self.secret_id = secret_id
        self.secret_key = secret_key
        self.endpoint = endpoint
        self.region_name = region_name
        self.scheme = scheme
        # the SDK derives the service host as bcc.<endpoint>;
        # bcc_host overrides it verbatim (test fixtures can't resolve
        # subdomains of 127.0.0.1) — the signature signs whatever
        # host is actually used, like the SDK
        self.bcc_host = bcc_host

    # -- wire --------------------------------------------------------------
    def _get(self, path: str, query: Dict[str, str]) -> dict:
        host = self.bcc_host or f"bcc.{self.endpoint}"
        auth = bce_authorization(self.secret_id, self.secret_key,
                                 "GET", path, query, host)
        qs = urllib.parse.urlencode(sorted(query.items()))
        url = f"{self.scheme}://{host}{path}" + (f"?{qs}" if qs else "")
        req = urllib.request.Request(
            url, headers={"Authorization": auth, "Host": host})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.load(r)

    def _marker_paged(self, path: str,
                      result_key: str) -> List[dict]:
        """marker/nextMarker while isTruncated (vpc.go:41-53)."""
        out: List[dict] = []
        marker = ""
        for _ in range(1000):
            q = {"maxKeys": str(PAGE_KEYS)}
            if marker:
                q["marker"] = marker
            doc = self._get(path, q)
            out.extend(doc.get(result_key, []))
            if not doc.get("isTruncated"):
                break
            marker = str(doc.get("nextMarker", ""))
            if not marker:
                break
        return out

    # -- api ---------------------------------------------------------------
    def check_auth(self) -> None:
        self._get("/v1/vpc", {"maxKeys": "1"})

    def get_cloud_data(self) -> List[Resource]:
        b = ResourceBuilder(self.domain)
        add = b.add

        region_id = add("region", self.region_name, self.region_name)
        for vpc in self._marker_paged("/v1/vpc", "vpcs"):
            vid = vpc.get("vpcId", "")
            if vid:
                add("vpc", vid, vpc.get("name") or vid,
                    region_id=region_id, cidr=vpc.get("cidr", ""))
        for sn in self._marker_paged("/v1/subnet", "subnets"):
            sid = sn.get("subnetId", "")
            if not sid:
                continue
            epc = b.get("vpc", sn.get("vpcId", ""))
            zone = sn.get("zoneName", "")
            if zone:
                add("az", zone, zone, region_id=region_id)
            add("subnet", sid, sn.get("name") or sid, epc_id=epc,
                cidr=sn.get("cidr", ""), az=zone)
        for inst in self._marker_paged("/v2/instance", "instances"):
            iid = inst.get("id", "")
            if not iid:
                continue
            epc = b.get("vpc", inst.get("vpcId", ""))
            vm_rid = add("vm", iid, inst.get("name") or iid,
                         epc_id=epc, vpc_id=epc,
                         ip=inst.get("internalIp", ""),
                         az=inst.get("zoneName", ""))
            # instance public address (vm.go:256-260 walks each
            # private ip's PublicIpAddress; the detail row also
            # carries the flat publicIp)
            pub = inst.get("publicIp", "")
            if pub:
                add_vm_public_addresses(b, iid, vm_rid, epc,
                                        [(pub, "")])
        return b.rows()
