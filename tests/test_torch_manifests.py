"""The port's deploy manifests (manifests/torch/) and the shipped configs
(manifests/server.yaml, agent.yaml) against the port's entry points, as
tests/test_manifests.py holds them against the JAX package's: every
object carries the fields kubectl requires, every container that runs
on the card names `deepflow_tpu_torch`, `--device cuda` and one GPU, and
the configs the manifests embed or mount drive the port's
`server.load_config` and `python -m deepflow_tpu_torch.agent --dry-run`.
"""

import os
import string
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

REPO = Path(__file__).resolve().parent.parent
MANIFESTS = REPO / "manifests"
K8S = MANIFESTS / "torch" / "deepflow-tpu-torch.yaml"
COMPOSE = MANIFESTS / "torch" / "docker-compose.yaml"
TEMPLATE_ENV = dict(DEEPFLOW_NODE_IP="10.0.0.1", DEEPFLOW_NODE_NAME="n1",
                    DEEPFLOW_SA_TOKEN="tok")


def load_all(path):
    with open(path) as f:
        return [d for d in yaml.safe_load_all(f) if d is not None]


def config_map(docs, name):
    return next(d for d in docs if d["kind"] == "ConfigMap"
                and d["metadata"]["name"] == name)


def agent_dry_run(tmp_path, cfg):
    cfg = dict(cfg, capture={"engine": "none"})
    p = tmp_path / "agent.yaml"
    p.write_text(yaml.safe_dump(cfg))
    return subprocess.run(
        [sys.executable, "-m", "deepflow_tpu_torch.agent", "-f", str(p),
         "--dry-run", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": str(REPO)})


def check_server_config(cfg):
    assert set(cfg) <= {"controller", "ingester", "querier",
                        "self_telemetry"}
    ing = cfg["ingester"]
    assert set(ing) <= {"host", "port", "debug_port", "store_path",
                        "n_decoders", "throttle_per_s", "store_max_bytes",
                        "tpu_sketch_window_s", "app_red_window_s"}
    assert cfg["controller"]["port"] == 20417
    assert ing["port"] == 30033


def test_server_yaml_through_port_load_config():
    from deepflow_tpu_torch.server import load_config
    check_server_config(load_config(str(MANIFESTS / "server.yaml")))


def test_agent_yaml_dry_run_through_port_agent(tmp_path):
    with open(MANIFESTS / "agent.yaml") as f:
        cfg = yaml.safe_load(f)
    r = agent_dry_run(tmp_path, cfg)
    assert r.returncode == 0, r.stderr
    assert "config ok" in r.stdout


def test_k8s_objects_have_required_fields():
    docs = load_all(K8S)
    kinds = [d["kind"] for d in docs]
    for required in ("Namespace", "Deployment", "DaemonSet", "Service",
                     "ConfigMap", "ServiceAccount", "ClusterRole",
                     "ClusterRoleBinding"):
        assert required in kinds
    assert sorted(kinds) == sorted(
        d["kind"] for d in load_all(MANIFESTS / "k8s" / "deepflow-tpu.yaml"))
    for d in docs:
        assert d.get("apiVersion") and d.get("kind")
        assert d["metadata"].get("name")
        if d["kind"] in ("Deployment", "DaemonSet"):
            tpl = d["spec"]["template"]
            sel = d["spec"]["selector"]["matchLabels"]
            assert set(sel.items()) <= set(
                tpl["metadata"]["labels"].items())
            for c in tpl["spec"]["containers"]:
                assert c.get("image") and c.get("command")
                cmd = " ".join(c["command"])
                assert "deepflow_tpu_torch." in cmd
                assert "deepflow_tpu." not in cmd
                assert "--device cuda" in cmd
                assert c["resources"]["limits"]["nvidia.com/gpu"] == 1


def test_k8s_config_maps_are_the_reference_ones(tmp_path):
    """The same server.yaml and agent template as the JAX deployment; the
    server config loads through the port, the rendered agent bootstrap
    holds only the port's AgentConfig fields and dry-runs."""
    docs = load_all(K8S)
    ref = load_all(MANIFESTS / "k8s" / "deepflow-tpu.yaml")
    for name in ("deepflow-tpu-server-config", "deepflow-tpu-agent-config"):
        assert config_map(docs, name)["data"] == config_map(ref, name)["data"]

    from deepflow_tpu_torch.server import load_config
    p = tmp_path / "server.yaml"
    p.write_text(config_map(docs, "deepflow-tpu-server-config")
                 ["data"]["server.yaml"])
    check_server_config(load_config(str(p)))

    tpl = config_map(docs, "deepflow-tpu-agent-config")["data"]["agent.yaml.tpl"]
    acfg = yaml.safe_load(string.Template(tpl).substitute(TEMPLATE_ENV))
    from deepflow_tpu_torch.agent.trident import AgentConfig
    assert set(acfg) - {"capture"} <= set(AgentConfig.__dataclass_fields__)
    r = agent_dry_run(tmp_path, acfg)
    assert r.returncode == 0, r.stderr
    assert "config ok" in r.stdout


@pytest.mark.parametrize("service", ["deepflow-tpu-server",
                                     "deepflow-tpu-agent"])
def test_compose_services_reserve_a_card(service):
    svc = yaml.safe_load(COMPOSE.read_text())["services"]
    ref = yaml.safe_load((MANIFESTS / "docker-compose.yaml").read_text())
    assert set(svc) == set(ref["services"])
    s = svc[service]
    assert s["command"].startswith(
        f"python -m deepflow_tpu_torch.{service.rsplit('-', 1)[1]} -f ")
    assert s["command"].endswith(" --device cuda")
    (dev,) = s["deploy"]["resources"]["reservations"]["devices"]
    assert dev["driver"] == "nvidia" and dev["count"] == 1
    assert "gpu" in dev["capabilities"]
    # the same configs as the JAX deployment, mounted from manifests/
    mounts = {v.split(":")[1]: v.split(":")[0] for v in s["volumes"]}
    conf = f"/etc/deepflow-tpu/{service.rsplit('-', 1)[1]}.yaml"
    assert (COMPOSE.parent / mounts[conf]).resolve() \
        == (MANIFESTS / Path(conf).name).resolve()
    assert (COMPOSE.parent / mounts["/srv/deepflow-tpu"]).resolve() == REPO
