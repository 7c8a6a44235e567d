"""AWS cloud platform client: SigV4-signed EC2 Query API gathering.

Reference: server/controller/cloud/aws/ (aws.go NewAws/CheckAuth +
region.go/vpc.go/network.go/vm.go/vinterface_and_ip.go) — the vendor
client that proves the cloud-platform interface against a real vendor
shape: signed requests, XML responses, NextToken pagination, region
fan-out. The reference links the AWS SDK; this is a from-scratch
implementation of the public contracts:

- AWS Signature Version 4 (the published HMAC-SHA256 canonical-request
  algorithm; validated against AWS's official test-vector in
  tests/test_cloud_aws.py);
- the EC2 Query API (Action=Describe* form POSTs, XML results,
  nextToken paging);
- normalization into this controller's Resource rows: region -> az ->
  vpc (epc) -> subnet -> host rows carrying private IPs, the same
  shapes the filereader/http platforms produce, so recorder/enrich
  downstream is identical.

Fixture-replayed in tests (zero egress here); `endpoint_template`
points the client at the recorder.

The port's own copy of the JAX package's `controller/cloud_aws.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence

from deepflow_tpu_torch.controller.cloud import ResourceBuilder
from deepflow_tpu_torch.controller.model import Resource

EC2_API_VERSION = "2016-11-15"


# -- AWS Signature Version 4 (public algorithm) ----------------------------
def _hmac(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def sigv4_signature(secret_key: str, date: str, region: str,
                    service: str, string_to_sign: str) -> str:
    k = _hmac(("AWS4" + secret_key).encode(), date)
    k = _hmac(k, region)
    k = _hmac(k, service)
    k = _hmac(k, "aws4_request")
    return hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()


def sigv4_headers(method: str, url: str, body: bytes, access_key: str,
                  secret_key: str, region: str, service: str = "ec2",
                  now: Optional[datetime.datetime] = None,
                  extra_headers: Optional[Dict[str, str]] = None
                  ) -> Dict[str, str]:
    """Authorization + x-amz-date headers for one request, per the
    SigV4 spec (canonical request -> string to sign -> derived-key
    HMAC chain)."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    date = now.strftime("%Y%m%d")
    parsed = urllib.parse.urlparse(url)
    host = parsed.netloc
    path = parsed.path or "/"
    # canonical query: key-sorted, strictly percent-encoded
    q = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
    cq = "&".join(f"{urllib.parse.quote(k, safe='-_.~')}="
                  f"{urllib.parse.quote(v, safe='-_.~')}"
                  for k, v in sorted(q))
    headers = {"host": host, "x-amz-date": amz_date,
               **{k.lower(): v for k, v in (extra_headers or {}).items()}}
    signed = ";".join(sorted(headers))
    ch = "".join(f"{k}:{headers[k].strip()}\n" for k in sorted(headers))
    payload_hash = hashlib.sha256(body).hexdigest()
    creq = "\n".join([method, urllib.parse.quote(path, safe="/-_.~"),
                      cq, ch, signed, payload_hash])
    scope = f"{date}/{region}/{service}/aws4_request"
    sts = "\n".join(["AWS4-HMAC-SHA256", amz_date, scope,
                     hashlib.sha256(creq.encode()).hexdigest()])
    sig = sigv4_signature(secret_key, date, region, service, sts)
    out = {"x-amz-date": amz_date,
           "Authorization": (
               f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
               f"SignedHeaders={signed}, Signature={sig}")}
    for k, v in (extra_headers or {}).items():
        out[k] = v
    return out


# -- EC2 Query XML ---------------------------------------------------------
def _strip_ns(root: ET.Element) -> ET.Element:
    for el in root.iter():
        if "}" in el.tag:
            el.tag = el.tag.split("}", 1)[1]
    return root


def _items(el: Optional[ET.Element], path: str) -> List[ET.Element]:
    return [] if el is None else el.findall(path + "/item")


def _text(el: ET.Element, path: str, default: str = "") -> str:
    got = el.findtext(path)
    return got if got is not None else default


def _tag_name(el: ET.Element, fallback: str) -> str:
    for t in _items(el, "tagSet"):
        if _text(t, "key") == "Name":
            return _text(t, "value") or fallback
    return fallback


class AwsPlatform:
    """check_auth()/get_cloud_data() against the EC2 Query API.

    `regions`: explicit include list; empty = DescribeRegions fan-out
    (the reference's includeRegions/excludeRegions knob).
    `endpoint_template`: '{region}'-templated base URL — the real
    service default, or the fixture recorder under test."""

    def __init__(self, domain: str, access_key_id: str,
                 secret_access_key: str,
                 regions: Sequence[str] = (),
                 api_default_region: str = "us-east-1",
                 endpoint_template: str =
                 "https://ec2.{region}.amazonaws.com/",
                 timeout_s: float = 15.0) -> None:
        self.domain = domain
        self.access_key_id = access_key_id
        self.secret_access_key = secret_access_key
        self.include_regions = tuple(regions)
        self.api_default_region = api_default_region
        self.endpoint_template = endpoint_template
        self.timeout_s = timeout_s
        self.api_calls = 0

    # -- transport ---------------------------------------------------------
    def _call(self, region: str, action: str,
              params: Optional[Dict[str, str]] = None) -> ET.Element:
        url = self.endpoint_template.format(region=region)
        form = {"Action": action, "Version": EC2_API_VERSION,
                **(params or {})}
        body = urllib.parse.urlencode(sorted(form.items())).encode()
        headers = sigv4_headers(
            "POST", url, body, self.access_key_id,
            self.secret_access_key, region,
            extra_headers={"content-type":
                           "application/x-www-form-urlencoded"})
        req = urllib.request.Request(url, data=body, headers=headers)
        self.api_calls += 1
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return _strip_ns(ET.fromstring(resp.read()))

    def _paged(self, region: str, action: str, set_path: str,
               params: Optional[Dict[str, str]] = None
               ) -> List[ET.Element]:
        """Follow nextToken until exhausted (DescribeInstances pages)."""
        out: List[ET.Element] = []
        token: Optional[str] = None
        for _ in range(64):                      # hostile-loop bound
            p = dict(params or {})
            if token:
                p["NextToken"] = token
            root = self._call(region, action, p)
            out.extend(_items(root, set_path))
            token = root.findtext("nextToken")
            if not token:
                break
        return out

    # -- platform contract -------------------------------------------------
    def check_auth(self) -> None:
        """DescribeRegions doubles as the credential probe (aws.go
        CheckAuth): a signature or permission error raises here."""
        self._regions()

    def _regions(self) -> List[str]:
        root = self._call(self.api_default_region, "DescribeRegions")
        names = [_text(r, "regionName")
                 for r in _items(root, "regionInfo")]
        if self.include_regions:
            names = [n for n in names if n in self.include_regions]
        return names

    def get_cloud_data(self) -> List[Resource]:
        b = ResourceBuilder(self.domain)
        add = b.add

        for region in self._regions():
            region_id = add("region", region, region)
            azs = self._call(region, "DescribeAvailabilityZones")
            for az in _items(azs, "availabilityZoneInfo"):
                add("az", _text(az, "zoneName"), _text(az, "zoneName"),
                    region_id=region_id)
            for vpc in self._paged(region, "DescribeVpcs", "vpcSet"):
                vpc_id = _text(vpc, "vpcId")
                add("vpc", vpc_id, _tag_name(vpc, vpc_id),
                    region_id=region_id, cidr=_text(vpc, "cidrBlock"))
            for sn in self._paged(region, "DescribeSubnets", "subnetSet"):
                sn_id = _text(sn, "subnetId")
                epc = b.get("vpc", _text(sn, "vpcId"))
                add("subnet", sn_id, _tag_name(sn, sn_id),
                    epc_id=epc, cidr=_text(sn, "cidrBlock"),
                    az=_text(sn, "availabilityZone"))
            for rsv in self._paged(region, "DescribeInstances",
                                   "reservationSet"):
                for inst in _items(rsv, "instancesSet"):
                    iid = _text(inst, "instanceId")
                    epc = b.get("vpc", _text(inst, "vpcId"))
                    ip = _text(inst, "privateIpAddress")
                    # EC2 instances are VMs (reference aws.go GetVMs ->
                    # chost rows, VIF_DEVICE_TYPE_VM), not hypervisor
                    # hosts — the round-5 model carries both types
                    add("vm", iid, _tag_name(inst, iid),
                        epc_id=epc, vpc_id=epc, ip=ip,
                        az=_text(inst, "placement/availabilityZone"),
                        subnet=_text(inst, "subnetId"))
            # ENIs -> vinterface + lan/wan ip rows (reference
            # vinterface_and_ip.go: unattached ENIs skipped, private
            # addresses as LAN ips, the association's public ip as
            # the WAN ip)
            for eni in self._paged(region, "DescribeNetworkInterfaces",
                                   "networkInterfaceSet"):
                eid = _text(eni, "networkInterfaceId")
                inst = _text(eni, "attachment/instanceId")
                if not eid or not inst:
                    continue
                vif = add("vinterface", eid, eid,
                          mac=_text(eni, "macAddress"),
                          subnet_id=b.get("subnet",
                                          _text(eni, "subnetId")),
                          device_vm_id=b.get("vm", inst))
                for ip_e in _items(eni, "privateIpAddressesSet"):
                    ip = _text(ip_e, "privateIpAddress")
                    if ip:
                        add("lan_ip", f"{eid}/{ip}", ip,
                            vinterface_id=vif, ip=ip)
                    # EIPs on SECONDARY private ips nest under each
                    # address item (vinterface_and_ip.go walks them
                    # all; the eni-level association is the primary)
                    pub2 = _text(ip_e, "association/publicIp")
                    if pub2:
                        add("wan_ip", f"{eid}/{pub2}", pub2,
                            vinterface_id=vif, ip=pub2)
                pub = _text(eni, "association/publicIp")
                if pub:
                    add("wan_ip", f"{eid}/{pub}", pub,
                        vinterface_id=vif, ip=pub)
            # NAT gateways ride the SAME EC2 Query API (reference
            # nat_gateway.go DescribeNatGateways); their public
            # addresses land as nat-linked floating_ips
            for nat in self._paged(region, "DescribeNatGateways",
                                   "natGatewaySet"):
                nid = _text(nat, "natGatewayId")
                if not nid:
                    continue
                # deleted gateways linger in DescribeNatGateways for
                # ~1h (their public IPs may already be reassigned);
                # the reference keeps only available ones
                # (aws/nat_gateway.go:60)
                if _text(nat, "state") != "available":
                    continue
                epc = b.get("vpc", _text(nat, "vpcId"))
                nat_rid = add("nat_gateway", nid, _tag_name(nat, nid),
                              vpc_id=epc, region_id=region_id)
                for addr in _items(nat, "natGatewayAddressSet"):
                    ip = _text(addr, "publicIp")
                    if ip:
                        add("floating_ip", f"{nid}/{ip}", ip,
                            vpc_id=epc, ip=ip,
                            nat_gateway_id=nat_rid)
        return b.rows()
