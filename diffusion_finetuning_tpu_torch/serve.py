"""HTTP txt2img serving on one card (port of the JAX package's
``scripts/serve.py``, without its multi-device options).

POST /generate  {"prompt": "...", "steps": 30, "height": 512, "width": 512,
                 "guidance_scale": 7.5, "scheduler": "dpm", "seed": 0,
                 "adapter": "name"}        -> image/png
POST /adapters  {"name": "...", "path": "lora.safetensors"}  -> 200
                (register a LoRA/TI adapter for per-request routing)

Concurrent requests are micro-batched by ``serving.GenerationServer``;
requests naming different adapters batch apart and generate with their own
trees.

Usage: python -m diffusion_finetuning_tpu_torch.serve MODEL_DIR
       [--lora path.safetensors] [--adapter name=path ...] [--port 8000]
       [--max_batch 8] [--device cuda|cpu]
"""

from __future__ import annotations

import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence, Tuple, Union

import torch

from .pipelines.pipeline import StableDiffusionPipeline, patch_pipe
from .serving import GenerationServer
from .utils.cli import Fire


def make_server(pipe, host: str = "127.0.0.1", port: int = 8000, max_batch: int = 8,
                adapter: Union[str, Sequence[str]] = ()
                ) -> Tuple[ThreadingHTTPServer, GenerationServer]:
    """The HTTP server (not yet serving) over a new ``GenerationServer`` of
    ``pipe``, with the ``name=path`` adapters registered."""
    server = GenerationServer(pipe, max_batch=max_batch)
    for spec in [adapter] if isinstance(adapter, str) else list(adapter):
        name, _, path = spec.partition("=")
        if not path:
            server.close()
            raise ValueError(f"--adapter expects name=path, got {spec!r}")
        server.register_adapter(name, path)
        print(f"registered adapter {name!r} from {path}")

    class Handler(BaseHTTPRequestHandler):
        def _body(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_POST(self):
            if self.path == "/adapters":
                try:
                    body = self._body()
                    server.register_adapter(body["name"], body["path"])
                    self.send_response(200)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                except Exception as e:
                    self.send_error(400, "adapter registration failed",
                                    " ".join(str(e).split())[:500])
                return
            if self.path != "/generate":
                self.send_error(404)
                return
            try:
                body = self._body()
                img = server.generate(
                    prompt=body.get("prompt", ""),
                    negative_prompt=body.get("negative_prompt", ""),
                    height=int(body.get("height", 512)), width=int(body.get("width", 512)),
                    steps=int(body.get("steps", 30)),
                    guidance_scale=float(body.get("guidance_scale", 7.5)),
                    scheduler=body.get("scheduler", "dpm"), seed=int(body.get("seed", 0)),
                    adapter=body.get("adapter"))
                buf = io.BytesIO()
                img.save(buf, format="PNG")
                data = buf.getvalue()
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            except Exception as e:
                # the status line stays protocol-clean; the detail goes in the body
                self.send_error(500, "generation failed", " ".join(str(e).split())[:500])

        def log_message(self, fmt, *args):
            print(f"[serve] {fmt % args}")

    return ThreadingHTTPServer((host, port), Handler), server


def serve(model_dir: str, lora: str = None, port: int = 8000, max_batch: int = 8,
          host: str = "127.0.0.1", adapter: Union[str, Sequence[str]] = (),
          device: str = "cuda"):
    """Load ``model_dir`` (bf16 on the card, fp32 on the CPU), install
    ``lora`` if given, and serve until interrupted."""
    dtype = torch.bfloat16 if device.startswith("cuda") else torch.float32
    pipe = StableDiffusionPipeline.from_pretrained(model_dir, dtype=dtype, device=device)
    if lora:
        patch_pipe(pipe, lora, patch_unet=True, patch_text=True, patch_ti=True)
    httpd, server = make_server(pipe, host, port, max_batch, adapter)
    print(f"serving txt2img on http://{host}:{httpd.server_address[1]}/generate")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        server.close()


if __name__ == "__main__":
    Fire(serve)
