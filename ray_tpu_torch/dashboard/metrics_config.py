"""Prometheus + Grafana auto-configuration.

Reference analog: ``python/ray/dashboard/modules/metrics/`` — on
session start the reference writes a Prometheus scrape config with
file-based service discovery plus generated Grafana provisioning
(datasource + default dashboards), so ``prometheus --config.file=...``
and a stock Grafana pick the cluster up with zero hand-editing. Same
artifact set here, generated from the live cluster's endpoints and
the system-metrics registry (dashboard/system_metrics.py). The gauge
names are the JAX package's (``ray_tpu_*``), so one Grafana dashboard
reads either package; the files carry this package's name.
"""

from __future__ import annotations

import json
import os

_PANELS = [
    ("Alive nodes", "ray_tpu_nodes_alive", "stat"),
    ("Workers", "ray_tpu_workers_total", "stat"),
    ("Actors alive", "ray_tpu_actors_alive", "stat"),
    ("Tasks pending", "ray_tpu_tasks_pending", "timeseries"),
    ("Tasks running", "ray_tpu_tasks_running", "timeseries"),
    ("Head queue depth", "ray_tpu_head_queue_depth", "timeseries"),
    ("Admission state", "ray_tpu_head_admission_state", "stat"),
    ("Admissions rejected", "ray_tpu_head_admissions_rejected",
     "timeseries"),
    ("Object store bytes", "ray_tpu_object_store_bytes",
     "timeseries"),
    ("Objects tracked", "ray_tpu_objects_total", "timeseries"),
    ("Node CPU %", "ray_tpu_node_cpu_percent", "timeseries"),
    ("Node memory used", "ray_tpu_node_mem_used_bytes",
     "timeseries"),
]


def generate_metrics_configs(out_dir: str,
                             targets: list[str],
                             scrape_interval_s: int = 5) -> dict:
    """Write the full observability config set under ``out_dir``:

    - ``prometheus.yml``: scrape config using file_sd over
      ``prom_targets.json`` (re-generate that file as the cluster
      scales; prometheus reloads it without restart — the reference's
      service-discovery pattern).
    - ``prom_targets.json``: current scrape targets (host dashboards'
      ``/metrics``).
    - ``grafana/provisioning/datasources/ray_tpu_torch.yml``: a Prometheus
      datasource pointed at localhost:9090.
    - ``grafana/provisioning/dashboards/ray_tpu_torch.yml`` +
      ``grafana/dashboards/ray_tpu_torch_dashboard.json``: a generated
      default dashboard over the core system metrics.

    Returns {artifact_name: path}.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths: dict[str, str] = {}

    sd_path = os.path.join(out_dir, "prom_targets.json")
    with open(sd_path, "w") as f:
        json.dump([{"targets": list(targets),
                    "labels": {"job": "ray_tpu_torch"}}], f, indent=1)
    paths["targets"] = sd_path

    prom_path = os.path.join(out_dir, "prometheus.yml")
    with open(prom_path, "w") as f:
        f.write(
            "global:\n"
            f"  scrape_interval: {scrape_interval_s}s\n"
            f"  evaluation_interval: {scrape_interval_s}s\n"
            "scrape_configs:\n"
            "  - job_name: ray_tpu_torch\n"
            "    file_sd_configs:\n"
            f"      - files: ['{sd_path}']\n"
            "        refresh_interval: 10s\n")
    paths["prometheus"] = prom_path

    gf = os.path.join(out_dir, "grafana")
    ds_dir = os.path.join(gf, "provisioning", "datasources")
    db_prov_dir = os.path.join(gf, "provisioning", "dashboards")
    db_dir = os.path.join(gf, "dashboards")
    for d in (ds_dir, db_prov_dir, db_dir):
        os.makedirs(d, exist_ok=True)

    ds_path = os.path.join(ds_dir, "ray_tpu_torch.yml")
    with open(ds_path, "w") as f:
        f.write(
            "apiVersion: 1\n"
            "datasources:\n"
            "  - name: ray_tpu_torch_prometheus\n"
            "    type: prometheus\n"
            "    access: proxy\n"
            "    url: http://localhost:9090\n"
            "    isDefault: true\n")
    paths["datasource"] = ds_path

    prov_path = os.path.join(db_prov_dir, "ray_tpu_torch.yml")
    with open(prov_path, "w") as f:
        f.write(
            "apiVersion: 1\n"
            "providers:\n"
            "  - name: ray_tpu_torch\n"
            "    folder: ray_tpu_torch\n"
            "    type: file\n"
            "    options:\n"
            f"      path: {db_dir}\n")
    paths["dashboard_provider"] = prov_path

    dash_path = os.path.join(db_dir, "ray_tpu_torch_dashboard.json")
    with open(dash_path, "w") as f:
        json.dump(_dashboard_json(), f, indent=1)
    paths["dashboard"] = dash_path
    return paths


def _dashboard_json() -> dict:
    panels = []
    for i, (title, metric, kind) in enumerate(_PANELS):
        w, h = (4, 4) if kind == "stat" else (12, 7)
        x = (i % 2) * 12 if kind != "stat" else (i % 6) * 4
        panels.append({
            "id": i + 1,
            "title": title,
            "type": kind,
            "datasource": {"type": "prometheus",
                           "uid": "ray_tpu_torch_prometheus"},
            "gridPos": {"h": h, "w": w, "x": x, "y": (i // 2) * 7},
            "targets": [{
                "expr": metric,
                "legendFormat": ("{{node}}"
                                 if "node_" in metric else title),
                "refId": "A",
            }],
        })
    return {
        "title": "ray_tpu_torch cluster",
        "uid": "ray-tpu-torch-default",
        "timezone": "browser",
        "refresh": "10s",
        "schemaVersion": 39,
        "panels": panels,
        "time": {"from": "now-30m", "to": "now"},
    }
