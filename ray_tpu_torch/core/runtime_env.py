"""Runtime environments: per-task/actor env vars and code shipping.

Role-equivalent of ray: python/ray/_private/runtime_env/ (the agent at
runtime_env_agent.py:161, working_dir.py, py_modules.py) collapsed into
the lease path: the driver *normalizes* a runtime_env (packaging local
dirs into content-addressed zips stored in GCS KV), the descriptor rides
the lease request, and the worker *applies* it at bind time — fetch,
extract, chdir, sys.path.  Workers are bound to (accelerator env,
runtime env) pairs, so reuse never leaks one env into another (the
reference starts dedicated workers per runtime env for the same reason).

Supported keys: ``env_vars`` (dict), ``working_dir`` (local dir),
``py_modules`` (list of local dirs/files), ``pip`` (per-env virtualenv),
``conda`` (per-env conda env, spec-hashed and cached node-side), and
``container`` (worker spawned inside a docker/podman container with the
session dir mounted).  pip/conda/container are mutually exclusive, like
the reference (ray: _private/runtime_env/{pip,conda,container}.py).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import zipfile
from typing import Any, Dict, List, Optional

from ray_tpu_torch.common.constants import session_root

_MAX_PACKAGE_BYTES = 256 * 1024 * 1024
_EXCLUDE_DIRS = {".git", "__pycache__", ".venv", "node_modules"}

# caches are scoped by cluster (scope key = GCS address): a package
# uploaded to cluster A must be re-uploaded when the driver reconnects
# to cluster B with a fresh blob store
_uploaded_hashes: set = set()  # (scope, sha) upload dedupe
_normalize_cache: dict = {}  # (scope, json(env)) -> descriptor


def _zip_path(path: str) -> bytes:
    buf = io.BytesIO()
    path = os.path.abspath(path)
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(path):
            zf.write(path, os.path.basename(path))
        else:
            for root, dirs, files in os.walk(path):
                dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
                for f in files:
                    full = os.path.join(root, f)
                    zf.write(full, os.path.relpath(full, path))
    data = buf.getvalue()
    if len(data) > _MAX_PACKAGE_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(data)} bytes "
            f"(max {_MAX_PACKAGE_BYTES}); ship data via the object store, "
            "not the code package"
        )
    return data


def normalize(
    env: Optional[Dict[str, Any]], kv_put, scope: str = ""
) -> Optional[dict]:
    """Driver side: validate, package, upload; return the wire descriptor.

    ``kv_put(key, value)`` stores a package once (content-addressed);
    ``scope`` identifies the target cluster for cache invalidation.
    """
    if not env:
        return None
    cache_key = (scope, json.dumps(env, sort_keys=True, default=str))
    cached = _normalize_cache.get(cache_key)
    if cached is not None:
        return cached
    unknown = set(env) - {
        "env_vars", "working_dir", "py_modules", "pip", "conda", "container",
    }
    if unknown:
        raise ValueError(f"unknown runtime_env keys: {sorted(unknown)}")
    isolation = [k for k in ("pip", "conda", "container") if env.get(k)]
    if len(isolation) > 1:
        raise ValueError(
            f"runtime_env keys {isolation} are mutually exclusive: pick "
            "ONE of pip (virtualenv over the base image), conda (own "
            "interpreter + native deps), or container (own image)"
        )
    desc: Dict[str, Any] = {}
    conda = env.get("conda")
    if conda is not None:
        # Canonical spec: {"dependencies": [...], "channels": [...]}.
        # Accepts a bare list of package specs, a dict, or a path to an
        # environment.yml (reference: runtime_env/conda.py accepts all
        # three).  Canonicalized + sorted so the node-side cache key is
        # stable across equivalent writings.
        if isinstance(conda, str):
            if not os.path.isfile(conda):
                raise ValueError(
                    f"conda: {conda!r} is not a file; pass a package list, "
                    "a spec dict, or a path to an environment.yml"
                )
            try:
                import yaml  # vendored with many bases; optional

                with open(conda) as f:
                    conda = yaml.safe_load(f)
            except ImportError as e:
                raise ValueError(
                    "conda: reading environment.yml needs pyyaml, which "
                    "this image lacks — pass the spec as a dict or "
                    "package list instead"
                ) from e
        if isinstance(conda, (list, tuple)):
            conda = {"dependencies": list(conda)}
        if not isinstance(conda, dict) or not conda.get("dependencies"):
            raise ValueError(
                "conda must be a package list, a spec dict with "
                "'dependencies', or an environment.yml path"
            )
        deps = conda["dependencies"]
        if not all(isinstance(d, str) for d in deps):
            raise ValueError(
                "conda dependencies must be plain package specs "
                "(nested pip: sections are not supported — use the pip "
                "runtime env for pip packages)"
            )
        desc["conda"] = {
            "dependencies": sorted(deps),
            "channels": sorted(conda.get("channels", [])),
        }
    container = env.get("container")
    if container is not None:
        if isinstance(container, str):
            container = {"image": container}
        if not isinstance(container, dict) or not container.get("image"):
            raise ValueError(
                "container must be an image name or a dict with 'image' "
                "(+ optional 'run_options': list of extra runtime flags)"
            )
        run_opts = container.get("run_options", [])
        if not all(isinstance(o, str) for o in run_opts):
            raise ValueError("container run_options must be strings")
        desc["container"] = {
            "image": container["image"],
            "run_options": list(run_opts),
        }
    pip = env.get("pip")
    if pip:
        # per-env virtualenv (reference: runtime_env/pip.py role): the
        # RAYLET materializes a venv keyed by the requirement list and
        # spawns the env's workers with its interpreter (worker reuse is
        # already partitioned by descriptor_key, so envs never mix)
        if isinstance(pip, dict):
            pip = pip.get("packages", [])
        if not (isinstance(pip, (list, tuple))
                and all(isinstance(p, str) for p in pip)):
            raise ValueError("pip must be a list of requirement strings")
        desc["pip"] = sorted(pip)
    env_vars = env.get("env_vars")
    if env_vars:
        if not all(
            isinstance(k, str) and isinstance(v, str)
            for k, v in env_vars.items()
        ):
            raise ValueError("env_vars must be str->str")
        desc["env_vars"] = dict(env_vars)

    def upload(path: str) -> str:
        data = _zip_path(path)
        sha = hashlib.sha256(data).hexdigest()[:32]
        if (scope, sha) not in _uploaded_hashes:
            kv_put(sha, data)
            _uploaded_hashes.add((scope, sha))
        return sha

    if env.get("working_dir"):
        desc["working_dir_pkg"] = upload(env["working_dir"])
    if env.get("py_modules"):
        desc["py_module_pkgs"] = [upload(p) for p in env["py_modules"]]
    out = desc or None
    # NB: cached per env DICT, like the reference's once-per-job upload —
    # mutating the directory after the first call does not re-package
    _normalize_cache[cache_key] = out
    return out


def descriptor_key(desc: Optional[dict]) -> str:
    """Stable identity for worker binding/reuse."""
    if not desc:
        return ""
    return hashlib.sha256(
        json.dumps(desc, sort_keys=True).encode()
    ).hexdigest()[:16]


def _extract_dir(sha: str) -> str:
    return os.path.join(session_root(), "runtime_envs", sha)


async def apply(desc: dict, kv_get) -> None:
    """Worker side: fetch packages, extract, bind this process to the env.

    ``kv_get`` is an async callable (GCS KV fetch).  Idempotent per
    package (content-addressed extract dirs).
    """
    for k, v in (desc.get("env_vars") or {}).items():
        os.environ[k] = v

    async def fetch_extract(sha: str) -> str:
        target = _extract_dir(sha)
        if not os.path.isdir(target):
            blob = await kv_get(sha)
            if blob is None:
                raise RuntimeError(f"runtime_env package {sha} missing")
            tmp = target + f".tmp{os.getpid()}"
            with zipfile.ZipFile(io.BytesIO(bytes(blob))) as zf:
                zf.extractall(tmp)
            try:
                os.rename(tmp, target)  # atomic: concurrent extracts race
            except OSError:
                import shutil

                shutil.rmtree(tmp, ignore_errors=True)
        return target

    pkgs: List[str] = []
    if desc.get("working_dir_pkg"):
        wd = await fetch_extract(desc["working_dir_pkg"])
        os.chdir(wd)
        pkgs.append(wd)
    for sha in desc.get("py_module_pkgs", ()):
        pkgs.append(await fetch_extract(sha))
    for p in pkgs:
        if p not in sys.path:
            sys.path.insert(0, p)
