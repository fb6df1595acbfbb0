"""Two composed deployments behind HTTP.

    python -m ray_tpu_torch.examples.serve_compose [--http-port 8099]
"""

import argparse
import json
import urllib.request

import ray_tpu_torch
from ray_tpu_torch import serve


@serve.deployment
class Embedder:
    def __call__(self, text):
        return {"embedding": [len(w) for w in text.split()]}


@serve.deployment(num_replicas=2)
class App:
    def __init__(self, embedder):
        self.embedder = embedder

    async def __call__(self, request):
        if hasattr(request, "json"):
            body = await request.json()
        else:
            body = request
        emb = await self.embedder.remote(body["text"])
        return {"dims": len(emb["embedding"]), **emb}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--http-port", type=int, default=8099)
    args = ap.parse_args(argv)
    ray_tpu_torch.init(num_cpus=4)
    handle = serve.run(App.bind(Embedder.bind()), http_port=args.http_port)

    # direct handle call
    print(ray_tpu_torch.get(handle.remote({"text": "hello torch port serve"})))

    # HTTP call
    req = urllib.request.Request(
        f"http://127.0.0.1:{args.http_port}/", method="POST",
        data=json.dumps({"text": "over http"}).encode(),
        headers={"Content-Type": "application/json"})
    print(json.load(urllib.request.urlopen(req)))

    serve.shutdown()
    ray_tpu_torch.shutdown()


if __name__ == "__main__":
    main()
