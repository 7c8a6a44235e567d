from deepflow_tpu_torch.replay.frames import (erspan_i, erspan_ii, eth_ipv4_tcp,
                                              eth_ipv4_udp, eth_ipv6_tcp,
                                              gre_teb, ip4, vxlan)
from deepflow_tpu_torch.replay.generator import SyntheticAgent

__all__ = ["SyntheticAgent", "eth_ipv4_tcp", "eth_ipv4_udp", "ip4",
           "vxlan", "gre_teb", "erspan_i", "erspan_ii", "eth_ipv6_tcp"]
