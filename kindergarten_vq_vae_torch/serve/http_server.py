"""Minimal stdlib HTTP front-end for the PyTorch reconstructor.

    python -m kindergarten_vq_vae_torch.serve.http_server <run_dir> [--port 8000] [--device cuda] \
        [--artifact <path>]

Endpoints (JSON in/out), as ``kindergarten_vq_vae_tpu/serve/http_server.py``:
- POST /reconstruct  {"sentences": [...]}  -> reconstructions + token acc (+codes)
- POST /encode       {"sentences": [...]}  -> sentence latents
- POST /codes        {"sentences": [...]}  -> VQ codebook indices (shelgon3)
- GET  /health                             -> {"status": "ok", "model": ...}

Single-threaded by design: requests serialize onto the one card; batching
happens inside the Reconstructor's buckets.
"""

from __future__ import annotations

import json
import traceback
from http.server import BaseHTTPRequestHandler, HTTPServer


def make_handler(reconstructor):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # quiet
            pass

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"status": "ok", "model": reconstructor.model_name})
            else:
                self._send(404, {"error": "unknown endpoint"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                sentences = req.get("sentences", [])
                if not isinstance(sentences, list) or not sentences:
                    self._send(400, {"error": "provide a non-empty 'sentences' list"})
                    return
                if self.path == "/reconstruct":
                    self._send(200, {"results": reconstructor.reconstruct(sentences)})
                elif self.path == "/encode":
                    self._send(200, {"latents": reconstructor.encode(sentences).tolist()})
                elif self.path == "/codes":
                    self._send(200, {"codes": reconstructor.codes(sentences)})
                else:
                    self._send(404, {"error": "unknown endpoint"})
            except Exception as e:  # serve errors as JSON, keep the server up
                traceback.print_exc()
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve_http(reconstructor, port: int = 8000, host: str = "127.0.0.1") -> HTTPServer:
    """A server of ``reconstructor`` (its ``reconstructor`` attribute), not yet serving."""
    server = HTTPServer((host, port), make_handler(reconstructor))
    server.reconstructor = reconstructor
    return server


def make_server(argv=None) -> HTTPServer:
    """The server the command line asks for, not yet serving (``--port 0``:
    a free port, ``server.server_address[1]``)."""
    import argparse

    from kindergarten_vq_vae_torch.serve.reconstructor import Reconstructor

    p = argparse.ArgumentParser(description="serve a trained run over HTTP")
    p.add_argument("run_dir")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--ckpt", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument("--artifact", default=None,
                   help="serve an exported program (serve/export.py, the path without its "
                        "suffix) instead of the live forward")
    args = p.parse_args(argv)

    rec = Reconstructor(args.run_dir, args.ckpt, device=args.device, artifact=args.artifact)
    server = serve_http(rec, args.port)
    what = f"artifact {args.artifact}" if args.artifact else "the live forward"
    print(f"serving {rec.model_name} from {args.run_dir} on :{server.server_address[1]} "
          f"({args.device}, {what})")
    return server


def main(argv=None):
    make_server(argv).serve_forever()


if __name__ == "__main__":
    main()
