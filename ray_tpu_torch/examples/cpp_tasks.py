"""C++ tasks and actors: native task bodies through the normal API.

The reference's C++ worker API (cpp/include/ray/api.h) lets users
write remote functions in C++. Here: write C++, compile once
(``ray_tpu_torch.cpp.compile_library``, g++ against
``ray_tpu_torch/cpp/ray_tpu.h``), call ``.remote()`` like any Python
task; actor state is a live C++ object inside the actor's worker process.

    python -m ray_tpu_torch.examples.cpp_tasks
"""

import os

import numpy as np

import ray_tpu_torch
from ray_tpu_torch import cpp

SRC = r"""
#include "ray_tpu.h"
using raytpu::Args; using raytpu::Bytes;

static Bytes dot(const Args& a) {           // two f64 buffers -> f64
  const double* x = reinterpret_cast<const double*>(a[0].data());
  const double* y = reinterpret_cast<const double*>(a[1].data());
  size_t n = a[0].size() / sizeof(double);
  double s = 0;
  for (size_t i = 0; i < n; ++i) s += x[i] * y[i];
  return raytpu::bytes_of(s);
}
RAY_TPU_TASK(dot);

class RunningMean {
  double sum_ = 0; int64_t n_ = 0;
 public:
  explicit RunningMean(const Args&) {}
  Bytes observe(const Args& a) {
    sum_ += raytpu::as<double>(a[0]); ++n_;
    return raytpu::bytes_of(sum_ / n_);
  }
};
RAY_TPU_ACTOR(RunningMean);
RAY_TPU_METHOD(RunningMean, observe);

RAY_TPU_MODULE();
"""


def main() -> None:
    ray_tpu_torch.init(num_cpus=2)
    path = cpp.compile_library(SRC)
    try:
        lib = cpp.load_library(path)
        x = np.arange(1000, dtype=np.float64)
        ref = lib.dot.remote(x, x)
        print("dot(x, x) =", cpp.to_f64(ray_tpu_torch.get(ref)))
        assert cpp.to_f64(ray_tpu_torch.get(ref)) == float(x @ x)

        Mean = lib.actor_class("RunningMean")
        m = Mean.remote()
        for v in (1.0, 2.0, 3.0):
            last = m.observe.remote(v)
        print("running mean =", cpp.to_f64(ray_tpu_torch.get(last)))
    finally:
        ray_tpu_torch.shutdown()
        os.unlink(path)
    print("ok")


if __name__ == "__main__":
    main()
