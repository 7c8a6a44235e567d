"""Huawei Cloud client: Keystone-style IAM token auth, from scratch.

Reference: server/controller/cloud/huawei/ — token.go:64-92 obtains a
PROJECT-SCOPED token by POSTing the password identity body to
`/v3/auth/tokens` (the token arrives in the X-Subject-Token response
HEADER, its expiry in the body), caches it per project, and re-creates
it around expiry (token.go:40-62); every data call then carries
X-Auth-Token against per-service hosts, paged by MARKER (limit+last
id until an empty page — huawei.go:215-245, the ports-style APIs
return short pages mid-stream so only an EMPTY page terminates) or
offset. vpc.go/network.go/vm.go pull /v1/{project}/vpcs,
/v1/{project}/subnets, /v2.1/{project}/servers/detail.

This is the FOURTH auth model on the one platform interface — a
session-token LIFECYCLE (obtain, cache, expire, refresh, retry-once
on 401) rather than per-request signing (AWS SigV4, Aliyun HMAC-SHA1
nonce, Tencent TC3 derived keys) — which is exactly what it proves:
the cloud layer isn't shaped around any one vendor's auth.

Emits the same normalized region/vpc/subnet/vm rows as the other
vendors.

The port's own copy of the JAX package's `controller/cloud_huawei.py` (host
code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import List, Optional

from deepflow_tpu_torch.controller.cloud import (ResourceBuilder,
                                                 add_vm_public_addresses)
from deepflow_tpu_torch.controller.model import Resource

PAGE_LIMIT = 50
# refresh this long before the reported expiry: a token that dies
# mid-gather would fail half the fan-out
_EXPIRY_SLACK_S = 300.0


class HuaweiPlatform:
    """Same duck type as the other vendor clients. endpoint_template
    carries {service} (per-service hosts; the fixture may serve all
    from one); iam_endpoint is the token issuer."""

    def __init__(self, domain: str, account_name: str, iam_name: str,
                 password: str, project_name: str, project_id: str,
                 iam_endpoint: str,
                 endpoint_template: str) -> None:
        self.domain = domain
        self.account_name = account_name
        self.iam_name = iam_name
        self.password = password
        self.project_name = project_name
        self.project_id = project_id
        self.iam_endpoint = iam_endpoint
        self.endpoint_template = endpoint_template
        self._token: Optional[str] = None
        self._token_expires: float = 0.0
        self.tokens_issued = 0

    # -- token lifecycle ---------------------------------------------------
    def _create_token(self) -> None:
        """POST the documented password-identity body; the token rides
        the X-Subject-Token response header (token.go:64-92)."""
        body = {"auth": {
            "identity": {
                "methods": ["password"],
                "password": {"user": {
                    "domain": {"name": self.account_name},
                    "name": self.iam_name,
                    "password": self.password}}},
            "scope": {"project": {"id": self.project_id}}}}
        req = urllib.request.Request(
            self.iam_endpoint + "/v3/auth/tokens",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            tok = r.headers.get("X-Subject-Token", "")
            doc = json.load(r)
        if not tok:
            raise RuntimeError("huawei IAM: no X-Subject-Token issued")
        expires = doc.get("token", {}).get("expires_at", "")
        try:
            import calendar
            # expires_at is UTC: timegm, NOT mktime (which would apply
            # the local zone's DST guessing and shift expiry by ±1h)
            self._token_expires = calendar.timegm(time.strptime(
                expires[:19], "%Y-%m-%dT%H:%M:%S"))
        except (ValueError, TypeError, OverflowError):
            self._token_expires = time.time() + 3600
        self._token = tok
        self.tokens_issued += 1

    def _token_value(self) -> str:
        if self._token is None or \
                time.time() >= self._token_expires - _EXPIRY_SLACK_S:
            self._create_token()
        return self._token or ""

    # -- wire --------------------------------------------------------------
    def _get(self, service: str, path: str,
             query: str = "") -> dict:
        url = (self.endpoint_template.format(service=service)
               + path + (f"?{query}" if query else ""))
        req = urllib.request.Request(
            url, headers={"X-Auth-Token": self._token_value()})
        try:
            with urllib.request.urlopen(req, timeout=30) as r:
                return json.load(r)
        except urllib.error.HTTPError as e:
            if e.code == 401 and self._token is not None:
                # expired server-side before our slack window: re-auth
                # ONCE and retry (the reference recreates per project)
                self._token = None
                req = urllib.request.Request(
                    url, headers={"X-Auth-Token": self._token_value()})
                with urllib.request.urlopen(req, timeout=30) as r:
                    return json.load(r)
            raise

    def _marker_paged(self, service: str, path: str,
                      result_key: str) -> List[dict]:
        """limit+marker until an EMPTY page (huawei.go:215-245: short
        pages occur mid-stream, so a non-full page is NOT the end)."""
        out: List[dict] = []
        marker = ""
        for _ in range(1000):
            q = f"limit={PAGE_LIMIT}"
            if marker:
                q += f"&marker={urllib.parse.quote(marker)}"
            rows = self._get(service, path, q).get(result_key, [])
            if not rows:
                break
            out.extend(rows)
            marker = str(rows[-1].get("id", ""))
            if not marker:
                break
        return out

    # -- api ---------------------------------------------------------------
    def check_auth(self) -> None:
        self._create_token()

    def get_cloud_data(self) -> List[Resource]:
        b = ResourceBuilder(self.domain)
        add = b.add

        # one project == one region in the reference's layout
        # (projects are per-region; URLs embed the project name)
        region_id = add("region", self.project_name,
                        self.project_name)
        pid = self.project_id
        for vpc in self._marker_paged("vpc", f"/v1/{pid}/vpcs",
                                      "vpcs"):
            vid = vpc.get("id", "")
            if vid:
                add("vpc", vid, vpc.get("name") or vid,
                    region_id=region_id, cidr=vpc.get("cidr", ""))
        for sn in self._marker_paged("vpc", f"/v1/{pid}/subnets",
                                     "subnets"):
            sid = sn.get("id", "")
            if not sid:
                continue
            epc = b.get("vpc", sn.get("vpc_id", ""))
            add("subnet", sid, sn.get("name") or sid, epc_id=epc,
                cidr=sn.get("cidr", ""),
                az=sn.get("availability_zone", ""))
        for srv in self._marker_paged(
                "ecs", f"/v2.1/{pid}/servers/detail", "servers"):
            sid = srv.get("id", "")
            if not sid:
                continue
            # vm.go:58-67: the vpc is the addresses dict's KEY; a
            # server with no resolvable vpc is excluded
            addresses = srv.get("addresses") or {}
            epc = 0
            ip = ""
            for vpc_key, addrs in addresses.items():
                got = b.get("vpc", vpc_key)
                if got:
                    epc = got
                    if addrs:
                        ip = addrs[0].get("addr", "")
                    break
            if not epc:
                continue
            vm_rid = add("vm", sid, srv.get("name") or sid,
                         epc_id=epc, vpc_id=epc, ip=ip,
                         az=srv.get("OS-EXT-AZ:availability_zone", ""))
            # "floating"-typed address entries are the VM's public
            # side (vm.go:158-186: WAN vinterface PER MAC — two NICs
            # with their own EIPs must not share one vif)
            add_vm_public_addresses(
                b, sid, vm_rid, epc,
                [(a2.get("addr", ""),
                  a2.get("OS-EXT-IPS-MAC:mac_addr", ""))
                 for addrs2 in addresses.values() for a2 in addrs2
                 if a2.get("OS-EXT-IPS:type") == "floating"])
        return b.rows()
