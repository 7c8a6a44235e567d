"""Compile the resource model into ingester/agent platform data.

Reference: server/controller/trisolaris/metadata/ builds per-consumer
PlatformData (interfaces, CIDRs, services, ACLs) from MySQL and pushes
version bumps to agents and ingesters. Here compile() derives the
enrich-layer tables (InterfaceInfo/CidrInfo/ServiceEntry) from the model
and the version gates reloads, exactly like PlatformInfoTable.reload.

The port's own copy of the JAX package's `controller/platform_compiler.py`
(host code; the port imports nothing of that package, nor torch).
"""

from __future__ import annotations

import ipaddress
from typing import List, Optional, Tuple

from deepflow_tpu_torch.controller.model import Resource, ResourceModel
from deepflow_tpu_torch.enrich.platform_data import (CidrInfo, InterfaceInfo,
                                                     PlatformDataManager,
                                                     ServiceEntry)


def _ip_u32(s) -> Optional[int]:
    """None for anything that isn't a well-formed IPv4 address — a single
    bad persisted row must not poison every later compile."""
    try:
        return int(ipaddress.IPv4Address(s))
    except (ValueError, TypeError):
        return None


def compile_platform_data(model: ResourceModel
                          ) -> Tuple[List[InterfaceInfo], List[CidrInfo],
                                     List[ServiceEntry], int]:
    """Derive enrichment tables + version from the resource model.

    Conventions in the model's attrs:
      pod:     ip, epc_id, pod_node_id, pod_ns_id, pod_group_id,
               pod_cluster_id, az_id, region_id, host_id, subnet_id
      host:    ip, az_id, region_id
      subnet:  cidr ("10.1.0.0/16"), epc_id, az_id, region_id
      service: ip, port, protocol, epc_id
    """
    interfaces: List[InterfaceInfo] = []
    cidrs: List[CidrInfo] = []
    services: List[ServiceEntry] = []

    for pod in model.list(type="pod"):
        ip = _ip_u32(pod.attr("ip"))
        if ip is None:
            continue
        interfaces.append(InterfaceInfo(
            epc_id=pod.attr("epc_id", 0), ip=ip,
            region_id=pod.attr("region_id", 0), az_id=pod.attr("az_id", 0),
            host_id=pod.attr("host_id", 0),
            subnet_id=pod.attr("subnet_id", 0),
            l3_device_type=10, l3_device_id=pod.id,   # 10 = pod (ref enum)
            pod_node_id=pod.attr("pod_node_id", 0),
            pod_ns_id=pod.attr("pod_ns_id", 0),
            pod_group_id=pod.attr("pod_group_id", 0),
            pod_id=pod.id,
            pod_cluster_id=pod.attr("pod_cluster_id", 0)))

    for host in model.list(type="host"):
        ip = _ip_u32(host.attr("ip"))
        if ip is None:
            continue
        interfaces.append(InterfaceInfo(
            epc_id=host.attr("epc_id", 0), ip=ip,
            region_id=host.attr("region_id", 0),
            az_id=host.attr("az_id", 0), host_id=host.id,
            l3_device_type=6, l3_device_id=host.id))  # 6 = host

    # ENI-sourced addresses (cloud vinterface + lan_ip/wan_ip rows):
    # every address a vinterface carries enriches flows with the
    # device VM's identity — secondary private IPs and EIPs included,
    # which the vm row's single primary ip cannot cover
    vifs = {v.id: v for v in model.list(type="vinterface")}
    vms_by_id = {v.id: v for v in model.list(type="vm")}
    for ip_row in (model.list(type="lan_ip")
                   + model.list(type="wan_ip")):
        ip = _ip_u32(ip_row.attr("ip") or ip_row.name)
        vif = vifs.get(ip_row.attr("vinterface_id", 0))
        if ip is None or vif is None:
            continue
        dev = vms_by_id.get(vif.attr("device_vm_id", 0))
        interfaces.append(InterfaceInfo(
            epc_id=(dev.attr("epc_id", dev.attr("vpc_id", 0))
                    if dev else 0),
            ip=ip,
            region_id=dev.attr("region_id", 0) if dev else 0,
            az_id=dev.attr("az_id", 0) if dev else 0,
            host_id=dev.attr("host_id", 0) if dev else 0,
            subnet_id=vif.attr("subnet_id", 0),
            l3_device_type=1 if dev else 0,
            l3_device_id=dev.id if dev else 0))

    for vm in model.list(type="vm"):
        # cloud instances (reference chost: VIF_DEVICE_TYPE_VM = 1,
        # controller/common/const.go:384) — distinct from hypervisor
        # hosts; round-5 cloud clients emit EC2/ECS instances as vm
        ip = _ip_u32(vm.attr("ip"))
        if ip is None:
            continue
        interfaces.append(InterfaceInfo(
            epc_id=vm.attr("epc_id", vm.attr("vpc_id", 0)), ip=ip,
            region_id=vm.attr("region_id", 0),
            az_id=vm.attr("az_id", 0),
            host_id=vm.attr("host_id", 0),
            l3_device_type=1, l3_device_id=vm.id))

    for sn in model.list(type="subnet"):
        cidr = sn.attr("cidr")
        try:
            net = ipaddress.IPv4Network(cidr, strict=False)
        except (ValueError, TypeError):
            continue
        cidrs.append(CidrInfo(
            epc_id=sn.attr("epc_id", 0), prefix=int(net.network_address),
            mask_len=net.prefixlen, region_id=sn.attr("region_id", 0),
            az_id=sn.attr("az_id", 0), subnet_id=sn.id))

    for svc in model.list(type="service"):
        ip = _ip_u32(svc.attr("ip"))
        services.append(ServiceEntry(
            epc_id=svc.attr("epc_id", 0),
            ip=ip or 0,
            port=svc.attr("port", 0),
            protocol=svc.attr("protocol", 6),
            service_id=svc.id))

    return interfaces, cidrs, services, model.version


class PlatformPusher:
    """Applies compiled platform data to a PlatformDataManager whenever the
    model version advances (in-process ingester; remote ingesters pull the
    same payload from the controller HTTP API)."""

    def __init__(self, model: ResourceModel,
                 manager: PlatformDataManager) -> None:
        self.model = model
        self.manager = manager
        self.push()
        model.subscribe(lambda diff: self.push())

    def push(self) -> bool:
        ifaces, cidrs, services, version = compile_platform_data(self.model)
        return self.manager.update(ifaces, cidrs, services, version)
