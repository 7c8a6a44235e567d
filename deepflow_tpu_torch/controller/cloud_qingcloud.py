"""QingCloud client: the iaas RPC protocol from scratch.

Reference: server/controller/cloud/qingcloud/ — qingcloud.go:138-185:
every call is a GET against `/iaas/` whose SORTED query (values
url-escaped with '+' as %20) is signed as
base64(HMAC-SHA256(secret, "GET\\n/iaas/\\n" + query)), the signature
itself url-escaped and appended; offset/limit paging driven by
total_count (GetResponse:195-230). QingCloud's resource model quirk,
kept faithfully: VPCs are ROUTERS (vpc.go reads router_id/router_name
from DescribeRouters), subnets are VXNETS (network.go: vxnet_id, cidr
from the attached router's ip_network), zones are the region axis
(region.go DescribeZones), and instances carry their vxnets inline
(vm.go:175+). Fifth vendor, fifth signature dialect (sorted-query
HMAC-SHA256 with escaped-signature transport).

Emits the same normalized region/az/vpc/subnet/vm rows as the rest.

The port's own copy of the JAX package's `controller/cloud_qingcloud.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Sequence

from deepflow_tpu_torch.controller.cloud import (ResourceBuilder,
                                                 add_vm_public_addresses)
from deepflow_tpu_torch.controller.model import Resource

PAGE_LIMIT = 100


def _escape(v: object) -> str:
    """quote with '+' normalized to %20 (qingcloud.go:174-176)."""
    return urllib.parse.quote(str(v), safe="").replace("+", "%20")


def signed_query(params: Dict[str, object], secret: str) -> str:
    """Sorted canonical query + the url-escaped base64 HMAC-SHA256
    signature over "GET\\n/iaas/\\n" + query."""
    parts = [f"{k}={_escape(v) if isinstance(v, str) else v}"
             for k, v in sorted(params.items())]
    qs = "&".join(parts)
    sts = "GET\n/iaas/\n" + qs
    sig = base64.b64encode(hmac.new(secret.encode(), sts.encode(),
                                    hashlib.sha256).digest()).decode()
    return f"{qs}&signature={urllib.parse.quote(sig, safe='')}"


class QingCloudPlatform:
    """Same duck type as the other vendor clients; `url` is the API
    base (the reference's q.url), `/iaas/` appended per call."""

    def __init__(self, domain: str, secret_id: str, secret_key: str,
                 url: str = "https://api.qingcloud.com",
                 zones: Optional[Sequence[str]] = None) -> None:
        self.domain = domain
        self.secret_id = secret_id
        self.secret_key = secret_key
        self.url = url.rstrip("/")
        self.include_zones = tuple(zones) if zones else ()

    # -- wire --------------------------------------------------------------
    def _page(self, action: str, offset: int,
              extra: Dict[str, object]) -> dict:
        params: Dict[str, object] = {
            "access_key_id": self.secret_id,
            "action": action,
            "limit": PAGE_LIMIT,
            "offset": offset,
            "signature_method": "HmacSHA256",
            "signature_version": 1,
            "time_stamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                        time.gmtime()),
            "version": 1,
        }
        # verbose=2 everywhere the reference sends it
        # (qingcloud.go:159-162's exclusion list)
        if action not in ("DescribeClusters",
                          "DescribeLoadBalancerListeners",
                          "DescribeRouters"):
            params["verbose"] = 2
        params.update(extra)
        q = signed_query(params, self.secret_key)
        with urllib.request.urlopen(f"{self.url}/iaas/?{q}",
                                    timeout=30) as r:
            return json.load(r)

    def get_response(self, action: str, result_key: str,
                     **extra) -> List[dict]:
        """offset/limit until total_count rows collected
        (GetResponse's loop); a missing result key is an API error."""
        out: List[dict] = []
        offset = 0
        for _ in range(1000):
            doc = self._page(action, offset, extra)
            if result_key not in doc:
                raise RuntimeError(
                    f"qingcloud {action}: ret_code="
                    f"{doc.get('ret_code')} {doc.get('message', '')}")
            rows = doc[result_key]
            out.extend(rows)
            total = int(doc.get("total_count", len(out)))
            if not rows or len(out) >= total:
                break
            offset += len(rows)
        return out

    # -- api ---------------------------------------------------------------
    def check_auth(self) -> None:
        self.get_response("DescribeZones", "zone_set")

    def get_cloud_data(self) -> List[Resource]:
        b = ResourceBuilder(self.domain)
        add = b.add

        region_id = add("region", "qingcloud", "qingcloud")
        zones = [z.get("zone_id", "") for z in
                 self.get_response("DescribeZones", "zone_set")
                 if z.get("status", "active") == "active"]
        zones = [z for z in zones if z]
        if self.include_zones:
            zones = [z for z in zones if z in self.include_zones]
        for zone in zones:
            add("az", zone, zone, region_id=region_id)
            # VPCs are routers (vpc.go:57-70)
            for rt in self.get_response("DescribeRouters",
                                        "router_set", zone=zone):
                rid_ = rt.get("router_id", "")
                if rid_:
                    add("vpc", rid_, rt.get("router_name") or rid_,
                        region_id=region_id,
                        cidr=rt.get("vpc_network", ""))
            # subnets are vxnets; cidr from the attached router
            # (network.go:59-86); unattached/self-managed skipped
            for vx in self.get_response("DescribeVxnets", "vxnet_set",
                                        zone=zone):
                vid = vx.get("vxnet_id", "")
                router = vx.get("router") or {}
                epc = b.get("vpc", router.get("router_id", ""))
                if not vid or not epc:
                    continue
                add("subnet", vid, vx.get("vxnet_name") or vid,
                    epc_id=epc, az=zone,
                    cidr=router.get("ip_network", ""))
            # instances carry their vxnets inline (vm.go:85-180)
            for vm in self.get_response("DescribeInstances",
                                        "instance_set", zone=zone,
                                        status="running"):
                iid = vm.get("instance_id", "")
                if not iid:
                    continue
                epc, ip = 0, ""
                pubs = []
                for vx in vm.get("vxnets") or ():
                    sub = b.get("subnet", vx.get("vxnet_id", ""))
                    if sub and not epc:
                        for row in b.rows():
                            if row.type == "subnet" and row.id == sub:
                                epc = row.attr("epc_id", 0)
                                break
                        ip = vx.get("private_ip", "")
                    # per-nic eip (vm.go:297: nic.eip.eip_addr)
                    eip = (vx.get("eip") or {}).get("eip_addr", "")
                    if eip:
                        pubs.append((eip, vx.get("nic_id", "")))
                vm_rid = add("vm", iid,
                             vm.get("instance_name") or iid,
                             epc_id=epc, vpc_id=epc, ip=ip, az=zone)
                add_vm_public_addresses(b, iid, vm_rid, epc, pubs)
        return b.rows()
