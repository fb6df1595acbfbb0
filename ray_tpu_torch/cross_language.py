"""Cross-language surface (counterpart of ``ray_tpu/cross_language.py``;
reference: python/ray/cross_language.py + ray.Language).

``cpp_function`` is REAL here: it binds a task exported by a C++
library built against ``ray_tpu_torch/cpp/ray_tpu.h`` (see
``ray_tpu_torch.cpp``), or against the JAX package's header of the same
macros and C ABI.
The Java worker is out of scope (COVERAGE.md N30), so the java_*
entry points raise with a pointer rather than silently failing at
call time.
"""

from __future__ import annotations

import enum


class Language(enum.Enum):
    """(reference: ray.Language — the cross-language task descriptor
    tag)."""

    PYTHON = 0
    JAVA = 1
    CPP = 2


def cpp_function(library_path: str, name: str, *, num_cpus: float = 1):
    """A handle to a C++ task exported from ``library_path``
    (reference: ray.cpp_function). Returns a ``.remote()``-able
    :class:`ray_tpu_torch.cpp.CppTask`."""
    from ray_tpu_torch import cpp
    return cpp.load_library(library_path, num_cpus=num_cpus).task(name)


def java_function(class_name: str, function_name: str):
    """(reference: ray.java_function) Java workers are out of scope —
    see COVERAGE.md N30."""
    raise NotImplementedError(
        "ray_tpu_torch has no Java worker (COVERAGE.md N30); only "
        "Python and C++ (ray_tpu_torch.cpp / ray_tpu_torch.cpp_function) "
        "tasks exist")


def java_actor_class(class_name: str):
    """(reference: ray.java_actor_class) Java workers are out of
    scope — see COVERAGE.md N30."""
    raise NotImplementedError(
        "ray_tpu_torch has no Java worker (COVERAGE.md N30); only "
        "Python and C++ (ray_tpu_torch.cpp) actors exist")
