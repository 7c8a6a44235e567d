"""The agent-side pieces the port's server half needs: the
packet-sequence envelope decoder (`packet_sequence`) and the sequenced
TCP sender (`sender.UniformSender`) that `runtime/stats.StatsShipper`
ships DFSTATS through. The capture agent itself is not ported."""
