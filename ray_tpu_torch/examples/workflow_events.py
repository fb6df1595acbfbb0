"""Durable workflows: events, dynamic continuations, crash resume.

    python -m ray_tpu_torch.examples.workflow_events
"""

import os
import shutil
import tempfile
import time

import ray_tpu_torch
from ray_tpu_torch import workflow


class FileEvent(workflow.EventListener):
    def poll_for_event(self, path):
        while not os.path.exists(path):
            time.sleep(0.05)
        with open(path) as f:
            return f.read()


@ray_tpu_torch.remote
def announce(payload):
    return f"event said: {payload}"


@ray_tpu_torch.remote
def fib(n):
    if n <= 1:
        return n
    return workflow.continuation(add.bind(fib.bind(n - 1),
                                          fib.bind(n - 2)))


@ray_tpu_torch.remote
def add(a, b):
    return a + b


def main() -> None:
    ray_tpu_torch.init(num_cpus=2)
    root = tempfile.mkdtemp()
    try:
        workflow.init(os.path.join(root, "storage"))

        # -- event step: the workflow parks until the event fires ----
        marker = os.path.join(root, "event")
        wid = workflow.run_async(
            announce.bind(workflow.wait_for_event(FileEvent, marker)))
        print("status while waiting:", workflow.get_status(wid))
        with open(marker, "w") as f:
            f.write("go!")
        print(workflow.get_output(wid, timeout=60))

        # -- dynamic workflow: steps return continuations ------------
        print("fib(9) =", workflow.run(fib.bind(9), workflow_id="fib9",
                                       timeout=120))
        # completed steps are durable: this resume is a cache read
        print("resumed =", workflow.resume("fib9", timeout=60))
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    print("ok")


if __name__ == "__main__":
    main()
