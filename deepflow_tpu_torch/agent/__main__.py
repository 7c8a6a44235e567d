"""Agent process entrypoint: `python -m deepflow_tpu_torch.agent -f agent.yaml`.

The port of the JAX package's `agent/__main__.py` (reference:
agent/src/main.rs:102): the process reads a small bootstrap config (the
controller address and little else; the full RuntimeConfig is PUSHED by
the controller after registration) and runs until signalled. The
config's keys are AgentConfig fields plus a `capture:` block choosing
the packet source; everything else arrives through the sync loop
(trident.py Agent.sync_once -> _apply_config). The file is read as YAML
where PyYAML is installed and as JSON otherwise.

Capture sources (agent/afpacket.py, agent/xdp.py, agent/pcap.py):
  capture: {engine: ring,  iface: eth0}     TPACKET_V3 mmap ring
  capture: {engine: xdp,   iface: eth0}     AF_XDP (XDP redirect into
                                            XSK rings; CONSUMES the
                                            queue's ingress -- analyzer
                                            deployments)
  capture: {engine: raw,   iface: eth0}     batched raw socket
  capture: {engine: pcap,  path: x.pcap}    replay a capture file
  capture: {engine: none}                   control-plane only
A `bpf:` block (BpfFilter's keywords: proto, port, sample_shift)
attaches a kernel-side socket filter to a ring or raw socket before it
binds (agent/bpf.py); its verdict counters ride the source.

`--device` places the flow map's batch reduction and the tick's Document
rollup (default cuda; without a card the process exits non-zero unless
it is given `--device cpu`).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading

_CAPTURE_KEYS = ("engine", "iface", "path", "batch_size", "block_size",
                 "block_count", "poll_ms", "snaplen", "bpf", "queue",
                 "frame_count")
_BPF_KEYS = ("proto", "port", "sample_shift")


def _read_config(path: str):
    """The bootstrap file's top-level value: YAML through PyYAML where
    it is installed, else JSON."""
    try:
        import yaml
    except ImportError:
        yaml = None
    with open(path) as f:
        if yaml is not None:
            return yaml.safe_load(f)
        text = f.read()
    if not text.strip():
        return None
    try:
        return json.loads(text)
    except ValueError as e:
        raise ValueError(
            f"{path}: PyYAML is not installed, so the config must be "
            f"JSON (a subset of YAML), and it is not: {e}") from None


def _config_errors() -> tuple:
    """The exceptions a bad bootstrap raises (PyYAML's, where present)."""
    errors = (OSError, ValueError, TypeError)
    try:
        import yaml
    except ImportError:
        return errors
    return errors + (yaml.YAMLError,)


def load_bootstrap(path: str) -> tuple:
    """Parse the bootstrap config into (AgentConfig, capture dict).

    Unknown keys are an error, not a warning: a typo'd config silently
    running on defaults is how a fleet ends up capturing nothing
    (the reference validates pushed config the same way --
    config.rs RuntimeConfig::validate).
    """
    # deferred: importing trident pulls torch (seconds); main() registers
    # signal handlers before paying that, so TERM-during-startup exits
    # cleanly instead of through the default handler
    from deepflow_tpu_torch.agent.trident import AgentConfig
    raw = _read_config(path) or {}
    capture = raw.pop("capture", {"engine": "none"}) or {"engine": "none"}
    unknown = set(capture) - set(_CAPTURE_KEYS)
    if unknown:
        raise ValueError(f"unknown capture keys: {sorted(unknown)}")
    engine = capture.get("engine", "none")
    if engine not in ("none", "raw", "ring", "xdp", "pcap"):
        raise ValueError(f"unknown capture engine {engine!r} "
                         "(none|raw|ring|xdp|pcap)")
    if engine == "pcap" and not capture.get("path"):
        raise ValueError("capture engine pcap requires path")
    if engine == "xdp" and not capture.get("iface"):
        raise ValueError("capture engine xdp requires iface")
    # per-engine knobs: reject mismatches here so --dry-run catches them
    if engine != "raw" and "snaplen" in capture:
        raise ValueError("snaplen applies to engine raw only; "
                         "the ring sizes frames via block_size")
    if engine != "ring" and ("block_size" in capture
                             or "block_count" in capture):
        raise ValueError("block_size/block_count apply to engine ring only")
    if engine != "xdp" and ("queue" in capture
                            or "frame_count" in capture):
        raise ValueError("queue/frame_count apply to engine xdp only")
    if "bpf" in capture:
        if engine not in ("raw", "ring"):
            # xdp has its own in-kernel program; socket filters don't
            # apply to XSK rings
            raise ValueError("bpf filters attach to live sockets "
                             "(engine raw or ring)")
        b = capture["bpf"] or {}
        unknown = set(b) - set(_BPF_KEYS)
        if unknown:
            raise ValueError(f"unknown bpf keys: {sorted(unknown)}")
        for k, hi in (("proto", 255), ("port", 65535),
                      ("sample_shift", 31)):
            v = b.get(k)
            if v is not None and (not isinstance(v, int)
                                  or not 0 <= v <= hi):
                raise ValueError(f"bpf {k} must be an int in "
                                 f"0..{hi}, got {v!r}")
    fields = AgentConfig.__dataclass_fields__
    unknown = set(raw) - set(fields)
    if unknown:
        raise ValueError(f"unknown agent config keys: {sorted(unknown)}")
    for k in ("so_plugins", "wasm_plugins", "local_macs"):
        if k in raw and isinstance(raw[k], list):
            raw[k] = tuple(raw[k])
    return AgentConfig(**raw), capture


def build_source(capture: dict):
    engine = capture.get("engine", "none")
    if engine == "none":
        return None
    if engine == "pcap":
        from deepflow_tpu_torch.agent.pcap import PcapFrameSource
        if not os.path.exists(capture["path"]):
            # PcapFrameSource opens lazily (in the capture thread, where
            # the error would only be swallowed) -- fail at startup
            raise OSError(f"pcap not found: {capture['path']}")
        return PcapFrameSource(capture["path"])
    kw = {}
    for k in ("batch_size", "poll_ms"):
        if k in capture:
            kw[k] = capture[k]
    filt = None
    if "bpf" in capture:
        # kernel-side filter on the capture socket (recv_engine BPF
        # injection): attached BEFORE the socket binds (prepare hook)
        # so no packet ever reaches userspace unfiltered
        from deepflow_tpu_torch.agent.bpf import BpfFilter
        filt = BpfFilter(**(capture["bpf"] or {}))
        kw["prepare"] = filt.attach_socket
    try:
        if engine == "ring":
            from deepflow_tpu_torch.agent.afpacket import TpacketV3Source
            for k in ("block_size", "block_count"):
                if k in capture:
                    kw[k] = capture[k]
            src = TpacketV3Source(capture.get("iface"), **kw)
        elif engine == "raw":
            from deepflow_tpu_torch.agent.afpacket import AfPacketSource
            if "snaplen" in capture:
                kw["snaplen"] = capture["snaplen"]
            src = AfPacketSource(capture.get("iface"), **kw)
        elif engine == "xdp":
            from deepflow_tpu_torch.agent.xdp import XdpSource
            for k in ("queue", "frame_count"):
                if k in capture:
                    kw[k] = capture[k]
            src = XdpSource(capture["iface"], **kw)
        else:
            raise ValueError(f"unknown capture engine {engine!r}")
    except BaseException:
        if filt is not None:
            filt.close()
        raise
    if filt is not None:
        src.bpf = filt          # counters + lifecycle ride the source
    return src


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="deepflow-tpu-agent",
        description="capture agent (managed when controller_url is set, "
                    "standalone otherwise)")
    ap.add_argument("-f", "--config", required=True,
                    help="bootstrap yaml or json (AgentConfig keys + "
                         "capture:)")
    ap.add_argument("--dry-run", action="store_true",
                    help="validate the bootstrap config and exit")
    ap.add_argument("--device", default="cuda",
                    help="where the flow map and the Document rollup run "
                         "(default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    # handlers FIRST: everything below pays the multi-second torch
    # import (load_bootstrap's AgentConfig pull included), and a TERM
    # during startup must reach the clean-close path, not the default
    # handler
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())

    try:
        cfg, capture = load_bootstrap(args.config)
    except _config_errors() as e:
        print(f"bad bootstrap config: {e}", file=sys.stderr)
        return 2
    if args.dry_run:
        print(f"config ok: controller={cfg.controller_url or 'standalone'} "
              f"ingester={cfg.ingester_addr} "
              f"capture={capture.get('engine', 'none')}")
        return 0

    from deepflow_tpu_torch.models.flow_suite import check_device
    try:
        device = check_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"bad device: {e}", file=sys.stderr)
        return 2

    # source BEFORE agent: a bad iface/pcap must fail through the clean
    # config-error path, not leave a half-started agent behind
    try:
        source = build_source(capture)
    except (OSError, ValueError, KeyError) as e:
        print(f"bad capture config: {e}", file=sys.stderr)
        return 2

    from deepflow_tpu_torch.agent.trident import Agent
    agent = Agent(cfg, device=device)
    loop = None
    agent.start()
    if source is not None and not stop.is_set():
        from deepflow_tpu_torch.agent.afpacket import CaptureLoop
        agent.attach_source(source)       # ebpf debug dump reads it
        loop = CaptureLoop(source, agent, stats=agent.stats)
        loop.start()
    stop.wait()
    if loop is not None:
        loop.close()
    agent.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
