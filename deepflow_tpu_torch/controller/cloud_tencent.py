"""Tencent Cloud client: API 3.0 (TC3-HMAC-SHA256) from scratch.

Reference: server/controller/cloud/tencent/ — tencent.go wraps the
vendor SDK's CommonClient per (service, region) and pages every
Describe* with Offset/Limit until TotalCount is exhausted
(tencent.go:206-240); region.go/az.go/vpc.go/network.go/vm.go pull
DescribeRegions/DescribeZones/DescribeVpcs/DescribeSubnets/
DescribeInstances and normalize. This client implements the vendor
wire protocol directly (same discipline as cloud_aws.py /
cloud_aliyun.py — no vendored SDK), making it the THIRD auth scheme
the one platform interface carries:

- TC3-HMAC-SHA256 signed POST: canonical request over the JSON body
  (content-type;host signed headers, hex-sha256 payload), a dated
  credential scope, and the derived-key chain
  TC3{secret} -> date -> service -> "tc3_request" -> signature
  (vs AWS's SigV4 scope/derivation details and Aliyun's single-step
  HMAC-SHA1 nonce signature);
- service-global endpooints with the region in the X-TC-Region
  header (vs per-region hosts);
- Offset/Limit + Response.TotalCount pagination (vs nextToken and
  PageNumber).

Emits the same normalized region/az/vpc/subnet/vm rows as the other
vendors, so recorder/tagrecorder/platform-compiler are untouched.

The port's own copy of the JAX package's `controller/cloud_tencent.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import time
import urllib.parse
import urllib.request
from typing import List, Optional, Sequence, Tuple

from deepflow_tpu_torch.controller.cloud import (ResourceBuilder,
                                                 add_vm_public_addresses)
from deepflow_tpu_torch.controller.model import Resource

CVM_VERSION = "2017-03-12"
VPC_VERSION = "2017-03-12"
CLB_VERSION = "2018-03-17"
PAGE_LIMIT = 100

# actions whose Offset/Limit are Integer-typed; every OTHER paged
# action takes them as STRINGS (tencent.go:47-55 pagesIntControl —
# the FULL reference set, mirrored exactly — + :209-213's strconv
# branch for the rest)
_INT_PAGED_ACTIONS = {
    "DescribeInstances", "DescribeNatGateways",
    "DescribeLoadBalancers", "DescribeNetworkInterfaces",
    "DescribeVpcPeerConnections",
    "DescribeNatGatewayDestinationIpPortTranslationNatRules",
}


def tc3_signature(secret_key: str, service: str, payload: bytes,
                  host: str, timestamp: int) -> Tuple[str, str]:
    """(authorization-ready signature hex, credential date) per the
    documented TC3 process: canonical request -> string-to-sign ->
    derived key chain."""
    date = time.strftime("%Y-%m-%d", time.gmtime(timestamp))
    ct = "application/json; charset=utf-8"
    canonical = ("POST\n/\n\n"
                 f"content-type:{ct}\nhost:{host}\n\n"
                 "content-type;host\n"
                 + hashlib.sha256(payload).hexdigest())
    scope = f"{date}/{service}/tc3_request"
    sts = ("TC3-HMAC-SHA256\n" + str(timestamp) + "\n" + scope + "\n"
           + hashlib.sha256(canonical.encode()).hexdigest())

    def _hmac(key: bytes, msg: str) -> bytes:
        return hmac.new(key, msg.encode(), hashlib.sha256).digest()

    k_date = _hmac(("TC3" + secret_key).encode(), date)
    k_service = _hmac(k_date, service)
    k_signing = _hmac(k_service, "tc3_request")
    return hmac.new(k_signing, sts.encode(),
                    hashlib.sha256).hexdigest(), date


def tc3_authorization(secret_id: str, secret_key: str, service: str,
                      payload: bytes, host: str,
                      timestamp: int) -> str:
    sig, date = tc3_signature(secret_key, service, payload, host,
                              timestamp)
    return ("TC3-HMAC-SHA256 "
            f"Credential={secret_id}/{date}/{service}/tc3_request, "
            "SignedHeaders=content-type;host, "
            f"Signature={sig}")


class TencentPlatform:
    """Same duck type as the other vendor clients (check_auth +
    get_cloud_data); endpoint_template carries {service} (hosts are
    service-global; the region rides the X-TC-Region header)."""

    def __init__(self, domain: str, secret_id: str, secret_key: str,
                 endpoint_template: str =
                 "https://{service}.tencentcloudapi.com",
                 regions: Optional[Sequence[str]] = None) -> None:
        self.domain = domain
        self.secret_id = secret_id
        self.secret_key = secret_key
        self.endpoint_template = endpoint_template
        self.include_regions = tuple(regions) if regions else ()

    # -- wire --------------------------------------------------------------
    def _call(self, service: str, version: str, action: str,
              region: str, body: Optional[dict] = None) -> dict:
        url = self.endpoint_template.format(service=service)
        host = urllib.parse.urlparse(url).netloc
        payload = json.dumps(body or {}).encode()
        ts = int(time.time())
        headers = {
            "Content-Type": "application/json; charset=utf-8",
            "Host": host,
            "X-TC-Action": action,
            "X-TC-Version": version,
            "X-TC-Timestamp": str(ts),
            "Authorization": tc3_authorization(
                self.secret_id, self.secret_key, service, payload,
                host, ts),
        }
        if region:
            headers["X-TC-Region"] = region
        req = urllib.request.Request(url, data=payload,
                                     headers=headers)
        with urllib.request.urlopen(req, timeout=30) as r:
            doc = json.load(r)
        resp = doc.get("Response", {})
        if "Error" in resp:
            raise RuntimeError(
                f"tencent {action}: {resp['Error'].get('Code')}")
        return resp

    def _paged(self, service: str, version: str, action: str,
               region: str, result_key: str) -> List[dict]:
        """Offset/Limit until TotalCount rows collected
        (tencent.go:206-240's loop; hard page cap as a lying-total
        guard)."""
        out: List[dict] = []
        offset = 0
        for _ in range(1000):
            if action in _INT_PAGED_ACTIONS:
                page: dict = {"Limit": PAGE_LIMIT, "Offset": offset}
            else:
                page = {"Limit": str(PAGE_LIMIT),
                        "Offset": str(offset)}
            resp = self._call(service, version, action, region, page)
            rows = resp.get(result_key, [])
            out.extend(rows)
            total = int(resp.get("TotalCount", len(out)))
            if not rows or len(out) >= total:
                break
            offset += len(rows)
        return out

    # -- api ---------------------------------------------------------------
    def check_auth(self) -> None:
        self._call("cvm", CVM_VERSION, "DescribeRegions", "")

    def _regions(self) -> List[str]:
        resp = self._call("cvm", CVM_VERSION, "DescribeRegions", "")
        names = [r.get("Region", "")
                 for r in resp.get("RegionSet", [])
                 if r.get("RegionState", "AVAILABLE") == "AVAILABLE"]
        names = [n for n in names if n]
        if self.include_regions:
            names = [n for n in names if n in self.include_regions]
        return names

    def get_cloud_data(self) -> List[Resource]:
        b = ResourceBuilder(self.domain)
        add = b.add

        for region in self._regions():
            region_id = add("region", region, region)
            zones = self._call("cvm", CVM_VERSION, "DescribeZones",
                               region)
            for z in zones.get("ZoneSet", []):
                zid = z.get("Zone", "")
                if zid:
                    add("az", zid, z.get("ZoneName") or zid,
                        region_id=region_id)
            for vpc in self._paged("vpc", VPC_VERSION, "DescribeVpcs",
                                   region, "VpcSet"):
                vid = vpc.get("VpcId", "")
                if not vid:
                    continue
                add("vpc", vid, vpc.get("VpcName") or vid,
                    region_id=region_id,
                    cidr=vpc.get("CidrBlock", ""))
            for sn in self._paged("vpc", VPC_VERSION,
                                  "DescribeSubnets", region,
                                  "SubnetSet"):
                sid = sn.get("SubnetId", "")
                if not sid:
                    continue
                epc = b.get("vpc", sn.get("VpcId", ""))
                add("subnet", sid, sn.get("SubnetName") or sid,
                    epc_id=epc, cidr=sn.get("CidrBlock", ""),
                    az=sn.get("Zone", ""))
            for inst in self._paged("cvm", CVM_VERSION,
                                    "DescribeInstances", region,
                                    "InstanceSet"):
                iid = inst.get("InstanceId", "")
                if not iid:
                    continue
                vpc_id = inst.get("VirtualPrivateCloud",
                                  {}).get("VpcId", "")
                epc = b.get("vpc", vpc_id)
                ips = inst.get("PrivateIpAddresses") or []
                vm_rid = add("vm", iid,
                             inst.get("InstanceName") or iid,
                             epc_id=epc, vpc_id=epc,
                             ip=ips[0] if ips else "",
                             az=inst.get("Placement",
                                         {}).get("Zone", ""))
                add_vm_public_addresses(
                    b, iid, vm_rid, epc,
                    [(p_, "") for p_ in
                     inst.get("PublicIpAddresses") or []])
            # NAT gateways + their floating ips (nat_gateway.go:35-80:
            # NatGatewaySet rows carry PublicIpAddressSet)
            for nat in self._paged("vpc", VPC_VERSION,
                                   "DescribeNatGateways", region,
                                   "NatGatewaySet"):
                nid = nat.get("NatGatewayId", "")
                if not nid:
                    continue
                epc = b.get("vpc", nat.get("VpcId", ""))
                nat_rid = add("nat_gateway", nid,
                              nat.get("NatGatewayName") or nid,
                              vpc_id=epc, region_id=region_id)
                for ip_e in nat.get("PublicIpAddressSet") or []:
                    ip = ip_e.get("PublicIpAddress", "")
                    if ip:
                        add("floating_ip", f"{nid}/{ip}", ip,
                            vpc_id=epc, ip=ip,
                            nat_gateway_id=nat_rid)
            # CLB load balancers + listeners (lb.go:42-108)
            for lb in self._paged("clb", CLB_VERSION,
                                  "DescribeLoadBalancers", region,
                                  "LoadBalancerSet"):
                lid = lb.get("LoadBalancerId", "")
                if not lid:
                    continue
                epc = b.get("vpc", lb.get("VpcId", ""))
                vips = lb.get("LoadBalancerVips") or []
                lb_rid = add("lb", lid,
                             lb.get("LoadBalancerName") or lid,
                             vpc_id=epc, region_id=region_id,
                             ip=vips[0] if vips else "",
                             lb_model=lb.get("LoadBalancerType", ""))
                lst = self._call("clb", CLB_VERSION,
                                 "DescribeListeners", region,
                                 {"LoadBalancerId": lid})
                for ln in lst.get("Listeners", []):
                    lnid = ln.get("ListenerId", "")
                    if lnid:
                        add("lb_listener", lnid,
                            ln.get("ListenerName") or lnid,
                            lb_id=lb_rid,
                            port=int(ln.get("Port", 0)),
                            protocol=ln.get("Protocol", ""))
        return b.rows()
