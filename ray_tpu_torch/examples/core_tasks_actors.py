"""Tasks, actors, objects — the core API in one script.

    python -m ray_tpu_torch.examples.core_tasks_actors
"""

import ray_tpu_torch


@ray_tpu_torch.remote
def square(x):
    return x * x


@ray_tpu_torch.remote
class Counter:
    def __init__(self):
        self.n = 0

    def incr(self, by=1):
        self.n += by
        return self.n


@ray_tpu_torch.remote
def head3(xs):
    return xs[:3]


def main() -> None:
    ray_tpu_torch.init(num_cpus=4)
    # tasks fan out; get() gathers
    print("squares:", ray_tpu_torch.get([square.remote(i) for i in range(8)]))

    # objects: put once, share by reference
    big = ray_tpu_torch.put(list(range(10_000)))
    print("head3:", ray_tpu_torch.get(head3.remote(big)))

    # actors hold state across calls
    c = Counter.remote()
    ray_tpu_torch.get([c.incr.remote() for _ in range(10)])
    print("count:", ray_tpu_torch.get(c.incr.remote(0)))

    # wait: first-completed semantics
    refs = [square.remote(i) for i in range(4)]
    done, rest = ray_tpu_torch.wait(refs, num_returns=2, timeout=30)
    print("done/rest:", len(done), len(rest))

    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
