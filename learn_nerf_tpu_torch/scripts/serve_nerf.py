"""HTTP render service for a trained vanilla NeRF model.

The serving surface of ``learn_nerf_tpu.scripts.serve_nerf``, on PyTorch:
loads a checkpoint once into a :class:`~.render_nerf.RenderSession` and
serves whole frames over HTTP, one render at a time (a lock serializes
renders; a frame already fills the card).

Endpoints:
  * ``GET /health`` -> ``{"ok": true}``
  * ``GET /metadata`` -> scene bbox + default resolution
  * ``POST /render`` -> ``image/png``.  Body = the dataset's per-view
    camera JSON (``z``/``origin``/``x``/``y``/``x_fov``/``y_fov``) plus
    optional ``width``/``height``.  400 for a malformed request, 500 for a
    render that fails, 404 for any other path.

Example:
  python -m learn_nerf_tpu_torch.scripts.serve_nerf --bf16 \\
      --model_path nerf.pkl data/metadata.json &
  curl -s -X POST --data @data/0000.json localhost:8008/render > view.png
"""

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..data.camera import CameraView
from .render_nerf import RenderSession, base_argparser

MAX_SIDE = 8192  # request sanity cap


def argparser():
    parser = base_argparser()
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8008, help="0 = pick a free port")
    parser.add_argument("metadata_json", type=str)
    return parser


def make_server(args) -> ThreadingHTTPServer:
    """Build the server (separate from :func:`main` so tests can bind port 0)."""
    session = RenderSession(args)
    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *_):  # one line per render below instead
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, {"ok": True})
            elif self.path == "/metadata":
                md = session.metadata
                self._json(
                    200,
                    dict(
                        bbox_min=list(md.bbox_min),
                        bbox_max=list(md.bbox_max),
                        default_width=args.width,
                        default_height=args.height,
                    ),
                )
            else:
                self._json(404, {"error": "GET /health, GET /metadata, or POST /render"})

        def do_POST(self):
            if self.path != "/render":
                return self._json(404, {"error": "POST /render"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                info = json.loads(self.rfile.read(n))
                view = CameraView.from_dict(info)
                width = int(info.get("width", args.width))
                height = int(info.get("height", args.height))
                if not (0 < width <= MAX_SIDE and 0 < height <= MAX_SIDE):
                    raise ValueError(f"width/height must be in [1, {MAX_SIDE}]")
            except (KeyError, TypeError, ValueError) as e:
                return self._json(400, {"error": f"bad request: {e}"})
            t0 = time.time()
            try:
                with lock:  # one render at a time
                    image = session.render_view(view, width=width, height=height)
                    session.images.clear()  # RenderSession accumulates (CLIs)
                from PIL import Image

                buf = io.BytesIO()
                Image.fromarray(image).save(buf, format="PNG")
                body = buf.getvalue()
            except Exception as e:  # noqa: BLE001
                # A render failure (values the request validation cannot
                # see) answers 500 instead of dropping the connection, so a
                # client can tell a bad view from a dead server.
                return self._json(500, {"error": f"render failed: {e}"})
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            print(f"rendered {width}x{height} in {time.time() - t0:.3f} s", flush=True)

    return ThreadingHTTPServer((args.host, args.port), Handler)


def main(argv=None):
    args = argparser().parse_args(argv)
    server = make_server(args)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port} (POST /render)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
