"""The port's native shm sanitizer/crash-stress harness
(``ray_tpu_torch/native/run_sanitizers.sh``): ASAN and TSAN builds of
``native/tests/stress_main.cpp`` over the port's ``store.cpp`` and
``channel.cpp``, which kill lock- and pin-holding processes mid-operation
and assert robust-mutex recovery; under TSAN any data race fails it.
Marked ``slow`` as tests/test_native_sanitizers.py is."""

import os
import shutil
import subprocess

import pytest

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "ray_tpu_torch",
                      "native", "run_sanitizers.sh")


@pytest.mark.slow
def test_sanitizer_stress_harness():
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    out = subprocess.run(["bash", SCRIPT], capture_output=True,
                         text=True, timeout=420)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "SANITIZER HARNESS PASSED" in out.stdout
    assert "channel_threads OK" in out.stdout
