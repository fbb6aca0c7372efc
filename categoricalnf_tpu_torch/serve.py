"""Serve a finished run over HTTP: samples, sample-quality metrics, info.

Counterpart of ``experiments/serve.py`` for the port: the set-shuffling,
set-summation, graph-coloring, language-modeling and molecule tasks.
Device work is serialized behind a lock; the HTTP layer is the stdlib
server.

Endpoints:
  GET  /health         -> {"status": "ok", "task": ..., "step": N}
  GET  /info           -> the run's config.json contents
  POST /sample         -> {"num_samples": int, "temperature": float}
                          -> {"samples": [...]}: sets as token lists;
                          colorings as {"edges", "colors", "valid"} of
                          fresh random graphs; text as strings of
                          seq_len characters; molecules as {"atoms",
                          "bonds", "smiles", "valid"}
  POST /sample_metrics -> same body; the task's sample_metrics dict

Usage (on a machine with a CUDA card):
    python -m categoricalnf_tpu_torch.serve --run DIR --port 8787
    curl -s -X POST localhost:8787/sample -d '{"num_samples": 4}'
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from categoricalnf_tpu_torch.inference import load_run
from categoricalnf_tpu_torch.tasks.graph_coloring import (GraphColoringTask,
                                                          coloring_validity)
from categoricalnf_tpu_torch.tasks.language import LanguageModelingTask
from categoricalnf_tpu_torch.tasks.molecules import MoleculeTask
from categoricalnf_tpu_torch.tasks.set_modeling import (SetShufflingTask,
                                                        SetSummationTask,
                                                        _sample_set)
from categoricalnf_tpu_torch.utils.config import load_config

MAX_SAMPLES = 65536


def _sample_payload(task, generator, n: int, temperature: float):
    """Task-native JSON-serializable samples."""
    if isinstance(task, (SetShufflingTask, SetSummationTask)):
        x = _sample_set(task.model, n, task.set_size, temperature, generator)
        return [[int(v) for v in row] for row in x]
    if isinstance(task, GraphColoringTask):
        # the graphs, like the noise, come from the request's generator
        seed = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                                 device=generator.device))
        batch = task._gen(np.random.default_rng(seed), n)
        x, _ = task.sample_graphs(batch, temperature, generator)
        adj, mask = batch["cond"]["adj"], batch["mask"]
        valid = coloring_validity(adj, x, mask)
        out = []
        for b in range(n):
            k = int(mask[b].sum())
            out.append({
                "edges": [[i, j] for i in range(k) for j in range(i + 1, k)
                          if adj[b, i, j] > 0],
                "colors": [int(c) for c in x[b, :k]],
                "valid": bool(valid[b])})
        return out
    if isinstance(task, LanguageModelingTask):
        return task.sample_text(n, temperature, generator)
    if isinstance(task, MoleculeTask):
        # node counts from the prior, seeded from the request's generator
        return task.molecules_json(*task.sample_many(n, temperature,
                                                     generator=generator))
    raise ValueError(f"no sample payload for task {type(task).__name__}")


class RunServer:
    """Owns the restored run and serializes device work."""

    def __init__(self, run_dir: str, device=None, **overrides):
        self.handle = load_run(run_dir, device=device, **overrides)
        self.config = load_config(run_dir)
        self.lock = threading.Lock()
        self._counter = 0

    def _next_generator(self) -> torch.Generator:
        self._counter += 1
        return self.handle.generator(self._counter)

    def health(self):
        return {"status": "ok", "task": self.handle.task.name,
                "step": self.handle.step}

    def sample(self, n: int, temperature: float):
        with self.lock:
            return _sample_payload(self.handle.task, self._next_generator(),
                                   n, temperature)

    def sample_metrics(self, n: int, temperature: float):
        with self.lock:
            m = self.handle.task.sample_metrics(
                generator=self._next_generator(), num_samples=n,
                temperature=temperature)
            return {k: float(v) for k, v in m.items()}


def make_handler(server: RunServer):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def do_GET(self):
            if self.path == "/health":
                return self._send(200, server.health())
            if self.path == "/info":
                return self._send(200, server.config)
            return self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(length) or b"{}")
                n = int(body.get("num_samples", 8))
                t = float(body.get("temperature", 1.0))
                if not 1 <= n <= MAX_SAMPLES:
                    raise ValueError(
                        f"num_samples {n} out of [1, {MAX_SAMPLES}]")
                if self.path == "/sample":
                    return self._send(200, {"samples": server.sample(n, t)})
                if self.path == "/sample_metrics":
                    return self._send(200, server.sample_metrics(n, t))
                return self._send(404,
                                  {"error": f"unknown path {self.path}"})
            except Exception as e:  # serve errors as JSON, keep serving
                return self._send(400, {"error": str(e)})

    return Handler


def main(argv=None):
    ap = argparse.ArgumentParser(description="Serve a finished run")
    ap.add_argument("--run", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without one)")
    ap.add_argument("--compute_dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="override the run's compute dtype (e.g. float32)")
    args = ap.parse_args(argv)
    overrides = ({"compute_dtype": args.compute_dtype}
                 if args.compute_dtype else {})
    server = RunServer(args.run, device=args.device, **overrides)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(server))
    print(f"serving {args.run} (task {server.handle.task.name}, "
          f"step {server.handle.step}) on {args.host}:{httpd.server_port}")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
