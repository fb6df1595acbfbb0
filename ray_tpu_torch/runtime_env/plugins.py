"""Runtime-env plugins + builder.

Reference analog: the plugin architecture of
``python/ray/_private/runtime_env/plugin.py:24`` (RuntimeEnvPlugin
ABC, one plugin per field, each contributing to a RuntimeEnvContext)
and the per-node runtime-env agent that builds envs on demand with
caching (``runtime_env_agent.py:161``). Here the driver process plays
the agent: envs are built once per content hash into a staging cache
and expressed to workers purely via environment variables (cwd +
PYTHONPATH + user env vars), which the worker entrypoint applies
before user code runs.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import zipfile
from dataclasses import dataclass, field
from typing import Any

from ray_tpu_torch.core.exceptions import RuntimeEnvSetupError



@dataclass
class RuntimeEnvContext:
    """What a built env means for a worker process."""

    env_vars: dict[str, str] = field(default_factory=dict)
    py_paths: list[str] = field(default_factory=list)
    working_dir: str | None = None
    # argv prefix wrapped around the worker command (container
    # plugin): the spawner execs prefix + [python, -m, worker_entry,
    # ...]. Carried to the spawn site as a JSON env var because env
    # vars are the only conduit that reaches BOTH the head's local
    # pool and the node daemons' pools unchanged.
    command_prefix: list[str] = field(default_factory=list)

    def to_env_vars(self) -> dict[str, str]:
        out = dict(self.env_vars)
        paths = list(self.py_paths)
        if self.working_dir:
            out["RAY_TPU_WORKING_DIR"] = self.working_dir
            paths.insert(0, self.working_dir)
        if paths:
            prior = out.get("PYTHONPATH", "")
            out["PYTHONPATH"] = os.pathsep.join(
                paths + ([prior] if prior else []))
        if self.command_prefix:
            out["RAY_TPU_CONTAINER_PREFIX"] = json.dumps(
                self.command_prefix)
        return out


class RuntimeEnvPlugin:
    """One runtime_env field. Subclass and ``register_plugin()`` to
    extend (the reference's extension point)."""

    name: str = ""
    priority: int = 50  # lower builds first; env_vars last

    def validate(self, value: Any) -> None:  # noqa: B027
        pass

    def build(self, value: Any, ctx: RuntimeEnvContext,
              cache_dir: str) -> None:
        raise NotImplementedError


class EnvVarsPlugin(RuntimeEnvPlugin):
    name = "env_vars"
    priority = 90  # applied last: explicit env vars win

    def build(self, value, ctx, cache_dir):
        ctx.env_vars.update(value or {})


def _stage(src: str, cache_dir: str, tag: str) -> str:
    """Copy a dir / file / zip into the env's staging dir, once."""
    dest = os.path.join(cache_dir, tag)
    if os.path.exists(dest):
        return dest
    tmp = dest + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    if zipfile.is_zipfile(src):
        with zipfile.ZipFile(src) as z:
            z.extractall(tmp)
    elif os.path.isdir(src):
        shutil.copytree(src, tmp, symlinks=True)
    else:
        os.makedirs(tmp, exist_ok=True)
        shutil.copy2(src, tmp)
    os.replace(tmp, dest)  # atomic: concurrent builders agree
    return dest


class WorkingDirPlugin(RuntimeEnvPlugin):
    name = "working_dir"
    priority = 10

    def build(self, value, ctx, cache_dir):
        staged = _stage(value, cache_dir, "working_dir")
        if not os.path.isdir(staged):
            raise RuntimeEnvSetupError(
                f"working_dir {value!r} did not stage to a directory")
        ctx.working_dir = staged


class PyModulesPlugin(RuntimeEnvPlugin):
    name = "py_modules"
    priority = 20

    def build(self, value, ctx, cache_dir):
        for i, mod in enumerate(value or []):
            staged = _stage(mod, cache_dir, f"py_module_{i}")
            # A staged dir that wraps a single file becomes an import
            # root; a staged package dir's PARENT is the import root.
            if os.path.isdir(mod) and os.path.exists(
                    os.path.join(mod, "__init__.py")):
                root = os.path.dirname(staged)
                renamed = os.path.join(root, os.path.basename(
                    os.path.normpath(mod)))
                if staged != renamed and not os.path.exists(renamed):
                    os.rename(staged, renamed)
                ctx.py_paths.append(root)
            else:
                ctx.py_paths.append(staged)


class PipPlugin(RuntimeEnvPlugin):
    """Gated: this deployment has no network egress, so pip installs
    cannot run. The plugin degrades to *verification* — every named
    distribution must already be importable — so user code fails fast
    with an actionable message instead of an ImportError mid-task."""

    name = "pip"
    priority = 30

    def build(self, value, ctx, cache_dir):
        import importlib.metadata as md
        pkgs = value.get("packages") if isinstance(value, dict) else value
        missing = []
        for spec in pkgs or []:
            dist = str(spec).split("==")[0].split(">=")[0].split(
                "<=")[0].strip()
            try:
                md.version(dist)
            except md.PackageNotFoundError:
                missing.append(dist)
        if missing:
            raise RuntimeEnvSetupError(
                f"runtime_env pip packages not available and cannot "
                f"be installed (no network egress in this "
                f"deployment): {missing}; bake them into the image "
                f"or drop them from runtime_env")


class CondaPlugin(RuntimeEnvPlugin):
    name = "conda"
    priority = 30

    def build(self, value, ctx, cache_dir):
        raise RuntimeEnvSetupError(
            "runtime_env conda environments are not supported in "
            "this deployment (no network egress); use env_vars / "
            "working_dir / py_modules, or bake deps into the image")


class ConfigPlugin(RuntimeEnvPlugin):
    name = "config"
    priority = 5

    def build(self, value, ctx, cache_dir):  # options only; no-op
        pass


class ContainerPlugin(RuntimeEnvPlugin):
    """Run the worker inside an OCI container (reference: the
    ``container`` runtime-env field / podman wrapper in the
    ``python/ray/_private/runtime_env/plugin.py`` family).

    ``{"container": {"image": IMG, "run_options": [...]}}`` makes the
    spawner exec ``<runner> run --rm --network=host -v /tmp:/tmp
    <run_options> IMG`` around the worker command. The session
    directory rides the /tmp bind mount, and host networking keeps
    the worker's dial-back to the head socket working unchanged.

    The runner binary defaults to ``podman`` and is OVERRIDABLE via
    ``RAY_TPU_CONTAINER_RUNNER`` — this image ships no container
    runtime, so production use brings podman/docker and tests inject
    a fake runner that execs the wrapped command (proving the whole
    seam: plugin -> env var -> spawner prefix -> worker boots through
    the runner).

    Cards: the spawner (``core/runtime.py`` ``WorkerHandle``) forwards
    ``CUDA_VISIBLE_DEVICES`` and the ``NVIDIA_*`` variables with the
    rest of the worker's environment, and a worker that holds cards
    gets the runner's flag that exposes them (:func:`card_flags`). The
    flag exposes every card of the host, and the forwarded
    ``CUDA_VISIBLE_DEVICES`` keeps the host's ids: exposing only the
    worker's card would renumber it to 0 inside the container, and the
    forwarded host id would then name a card that is not there. A CPU
    worker's ``CUDA_VISIBLE_DEVICES`` is empty and gets no flag.

    Workers that a node daemon spawns are not wrapped (the JAX
    package's daemons do not wrap theirs either); only the driver's
    and the head's own workers run in the container."""

    name = "container"
    priority = 15

    def validate(self, value):
        if not isinstance(value, dict) or not isinstance(
                value.get("image"), str) or not value["image"]:
            raise ValueError(
                "runtime_env container must be a dict with a "
                "non-empty string 'image' key")
        ro = value.get("run_options", [])
        if not isinstance(ro, (list, tuple)) or not all(
                isinstance(x, str) for x in ro):
            raise ValueError("container run_options must be a "
                             "list of strings")

    def build(self, value, ctx, cache_dir):
        # NB: this check runs DRIVER-side — a daemon node whose PATH
        # lacks the runner still fails at spawn (generic worker-died);
        # homogeneous node images are assumed, as in the reference.
        runner = os.environ.get("RAY_TPU_CONTAINER_RUNNER", "podman")
        if shutil.which(runner) is None:
            raise RuntimeEnvSetupError(
                f"runtime_env container requires a container "
                f"runtime; {runner!r} is not on PATH (set "
                f"RAY_TPU_CONTAINER_RUNNER to your runner binary)")
        # Image LAST: the spawner splices --env KEY=VALUE forwards
        # right before it (a real OCI runner does not inherit the
        # host process env the rest of the runtime-env design rides
        # on — reference container support forwards env explicitly).
        ctx.command_prefix = [
            runner, "run", "--rm", "--network=host", "-v",
            "/tmp:/tmp", *value.get("run_options", []),
            value["image"]]


def card_flags(runner: str) -> list[str]:
    """The runner's flag that exposes the host's cards to a container,
    chosen by the runner's basename: docker's ``--gpus=all``, or a CDI
    device (podman and other CDI runners) ``--device=nvidia.com/gpu=all``.
    One token each, as the ``--env=`` forwards are."""
    if "docker" in os.path.basename(runner):
        return ["--gpus=all"]
    return ["--device=nvidia.com/gpu=all"]


_plugins: dict[str, RuntimeEnvPlugin] = {}
_plugins_lock = threading.Lock()
_build_cache: dict[str, RuntimeEnvContext] = {}


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    if not plugin.name:
        raise ValueError("plugin must set a name")
    with _plugins_lock:
        _plugins[plugin.name] = plugin


def plugin_names() -> list[str]:
    with _plugins_lock:
        return list(_plugins)


for _p in (EnvVarsPlugin(), WorkingDirPlugin(), PyModulesPlugin(),
           PipPlugin(), CondaPlugin(), ConfigPlugin(),
           ContainerPlugin()):
    register_plugin(_p)


def _env_hash(runtime_env: dict) -> str:
    def canon(v):
        if isinstance(v, dict):
            return {k: canon(v[k]) for k in sorted(v)}
        if isinstance(v, (list, tuple)):
            return [canon(x) for x in v]
        return v
    # Content-hash staged paths so editing a working_dir yields a new
    # env instead of silently reusing the stale staged copy.
    extra = {}
    if "container" in runtime_env:
        # The resolved runner is a build() input: changing it
        # mid-process must not reuse a prefix baked for the old one.
        extra["container_runner"] = os.environ.get(
            "RAY_TPU_CONTAINER_RUNNER", "podman")
    for key in ("working_dir",):
        p = runtime_env.get(key)
        if p and os.path.exists(p):
            extra[key + "_mtime"] = _tree_fingerprint(p)
    for i, p in enumerate(runtime_env.get("py_modules") or []):
        if os.path.exists(p):
            extra[f"py_module_{i}_mtime"] = _tree_fingerprint(p)
    blob = json.dumps([canon(runtime_env), extra], sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def _tree_fingerprint(path: str) -> str:
    h = hashlib.sha1()
    if os.path.isfile(path):
        st = os.stat(path)
        h.update(f"{path}:{st.st_size}:{st.st_mtime_ns}".encode())
    else:
        for root, dirs, files in os.walk(path):
            dirs.sort()
            for f in sorted(files):
                fp = os.path.join(root, f)
                try:
                    st = os.stat(fp)
                except OSError:
                    continue
                h.update(
                    f"{fp}:{st.st_size}:{st.st_mtime_ns}".encode())
    return h.hexdigest()[:16]


def build_runtime_env(runtime_env: dict | None) -> RuntimeEnvContext:
    """Build (with caching) the context for a runtime_env dict."""
    if not runtime_env:
        return RuntimeEnvContext()
    from ray_tpu_torch.runtime_env.runtime_env import validate_runtime_env
    validate_runtime_env(runtime_env)

    key = _env_hash(runtime_env)
    with _plugins_lock:
        cached = _build_cache.get(key)
        plugins = sorted(_plugins.values(), key=lambda p: p.priority)
    if cached is not None:
        return cached

    from ray_tpu_torch.core.config import temp_path
    cache_dir = os.path.join(temp_path("ray_tpu_torch_runtime_envs"), key)
    os.makedirs(cache_dir, exist_ok=True)
    ctx = RuntimeEnvContext()
    for plugin in plugins:
        if plugin.name in runtime_env:
            plugin.validate(runtime_env[plugin.name])
            plugin.build(runtime_env[plugin.name], ctx, cache_dir)
    with _plugins_lock:
        _build_cache[key] = ctx
    return ctx
