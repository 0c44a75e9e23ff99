"""Declarative Serve config: deploy applications from a dict/YAML spec.

Role-equivalent of ray: python/ray/serve/schema.py (ServeDeploySchema /
ServeApplicationSchema) + `serve deploy` — an application is named by an
import path (``module:app`` where ``app`` is a bound Application), with
per-deployment overrides applied on top of the code-level settings:

    applications:
      - name: text_gen
        route_prefix: /generate
        import_path: my_project.serving:app
        deployments:
          - name: TextGen
            num_replicas: 4
            max_ongoing_requests: 16
    http_options:
      port: 8000

``serve.deploy_config(cfg)`` accepts the dict form;
``serve.deploy_config_file(path)`` reads YAML.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, List, Optional

from ray_tpu_torch.serve.deployment import Application, Deployment


@dataclasses.dataclass
class DeploymentOverride:
    name: str
    num_replicas: Optional[int] = None
    max_ongoing_requests: Optional[int] = None
    autoscaling_config: Optional[dict] = None
    ray_actor_options: Optional[dict] = None
    # SLO/queueing policy override (serve/traffic TrafficConfig fields);
    # normalized by Deployment.__post_init__ like the decorator path
    traffic_config: Optional[dict] = None

    @staticmethod
    def from_dict(d: dict) -> "DeploymentOverride":
        known = {f.name for f in dataclasses.fields(DeploymentOverride)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown deployment option(s) {sorted(unknown)}"
            )
        return DeploymentOverride(**d)


@dataclasses.dataclass
class ApplicationSpec:
    name: str
    import_path: str
    route_prefix: Optional[str] = "/"
    deployments: List[DeploymentOverride] = dataclasses.field(
        default_factory=list
    )

    @staticmethod
    def from_dict(d: dict) -> "ApplicationSpec":
        return ApplicationSpec(
            name=d["name"],
            import_path=d["import_path"],
            route_prefix=d.get("route_prefix", "/"),
            deployments=[
                DeploymentOverride.from_dict(x)
                for x in d.get("deployments", [])
            ],
        )


def _import_target(import_path: str) -> Application:
    if ":" not in import_path:
        raise ValueError(
            f"import_path must be 'module:attribute', got {import_path!r}"
        )
    module_name, attr = import_path.split(":", 1)
    mod = importlib.import_module(module_name)
    target = getattr(mod, attr)
    if isinstance(target, Deployment):
        target = Application(target)
    if not isinstance(target, Application):
        raise TypeError(
            f"{import_path} resolved to {type(target).__name__}, expected a "
            "bound Application (deployment.bind(...))"
        )
    return target


def _apply_overrides(app: Application, overrides: List[DeploymentOverride]):
    by_name = {o.name: o for o in overrides}
    d = app.deployment
    o = by_name.get(d.name)
    if o is None:
        return app
    changes: Dict[str, Any] = {}
    if o.num_replicas is not None:
        changes["num_replicas"] = o.num_replicas
    if o.max_ongoing_requests is not None:
        changes["max_ongoing_requests"] = o.max_ongoing_requests
    if o.autoscaling_config is not None:
        changes["autoscaling_config"] = o.autoscaling_config
    if o.ray_actor_options is not None:
        changes["ray_actor_options"] = o.ray_actor_options
    if o.traffic_config is not None:
        changes["traffic_config"] = o.traffic_config
    return Application(d.options(**changes))


def deploy_config(config: dict) -> Dict[str, Any]:
    """Deploy every application in a declarative config dict; returns
    {app_name: handle}."""
    from ray_tpu_torch.serve import api as serve_api

    handles = {}
    http_port = (config.get("http_options") or {}).get("port")
    for app_dict in config.get("applications", []):
        spec = ApplicationSpec.from_dict(app_dict)
        app = _import_target(spec.import_path)
        app = _apply_overrides(app, spec.deployments)
        handles[spec.name] = serve_api.run(
            app,
            name=spec.name,
            route_prefix=spec.route_prefix,
            http_port=http_port,
        )
    return handles


def deploy_config_file(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        return deploy_config(yaml.safe_load(f))
