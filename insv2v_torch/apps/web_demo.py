"""Dependency-free web UI of the port for instruction video editing.

    python -m insv2v_torch.apps.web_demo --ckpt insv2v.pth --port 7860

Counterpart of ``apps/web_demo.py`` in the JAX package: the gradio demo's
handler (``apps/gradio_demo.py::run_edit``, imported from there so the two
front ends cannot drift apart) served by the standard library's
``http.server``:

  GET  /        the form (prompt, text and video CFG, noise correction,
                motion compensation, seed, the preset examples)
  POST /edit    a multipart upload -> the edit -> the page with the GIF
                inline (base64), or the raw ``image/gif`` for a request
                that accepts ``image/*``

400 without a video or a prompt, 404 on any other path, 413 for a body
over ``MAX_BODY_BYTES`` (before reading it). One lock serializes the edits
on the one card. The flags are the JAX demo's, plus ``--device``: the
editor runs on the GPU (the default; a request raises without one) or on
the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse
import base64
import email.parser
import email.policy
import html
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from insv2v_torch.apps.gradio_demo import EXAMPLES, run_edit

MAX_BODY_BYTES = 100 * 1024 * 1024  # refused before the body is read

# one card: concurrent edits would only contend for its memory
_EDIT_LOCK = threading.Lock()

_PAGE = """<!doctype html>
<html><head><title>InsV2V: instruction video editing</title>
<style>
 body {{ font-family: sans-serif; max-width: 46rem; margin: 2rem auto; }}
 label {{ display: block; margin-top: .8rem; }}
 input[type=text] {{ width: 100%; }}
 .ex {{ color: #555; font-size: .9rem; }}
 img {{ max-width: 100%; margin-top: 1rem; }}
</style></head><body>
<h2>InsV2V: instruction-driven video editing</h2>
<form method="post" action="/edit" enctype="multipart/form-data">
 <label>input video (mp4/gif) <input type="file" name="video" required></label>
 <label>edit instruction <input type="text" name="prompt" required
        placeholder="make it Van Gogh Starry Night style"></label>
 <label>text cfg <input type="number" name="text_cfg" value="7.5"
        min="1" max="15" step="0.5"></label>
 <label>video cfg <input type="number" name="video_cfg" value="1.2"
        min="1" max="3" step="0.1"></label>
 <label>noise correction <input type="number" name="noise_correct"
        value="0.5" min="0" max="1" step="0.1"></label>
 <label>motion compensation
        <input type="checkbox" name="motion_comp" checked></label>
 <label>seed <input type="number" name="seed" value="0"></label>
 <p><button type="submit">edit</button></p>
</form>
<p class="ex">examples: {examples}</p>
{result}
</body></html>"""


def _render(result: str = "") -> bytes:
    ex = " · ".join(html.escape(e[0]) for e in EXAMPLES)
    return _PAGE.format(examples=ex, result=result).encode()


def _parse_multipart(headers, body: bytes):
    """A multipart/form-data body -> {name: bytes}, through the email
    parser (the standard library's ``cgi`` module is gone in 3.13)."""
    msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
        b"Content-Type: " + headers.get("Content-Type", "").encode()
        + b"\r\nMIME-Version: 1.0\r\n\r\n" + body)
    fields = {}
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if name:
            payload = part.get_payload(decode=True)
            fields[name] = payload if payload is not None else b""
    return fields


def make_handler(args):
    class Handler(BaseHTTPRequestHandler):
        def _send(self, code, body, ctype="text/html; charset=utf-8"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path not in ("/", "/index.html"):
                return self._send(404, b"not found", "text/plain")
            self._send(200, _render())

        def do_POST(self):
            if self.path != "/edit":
                return self._send(404, b"not found", "text/plain")
            length = int(self.headers.get("Content-Length", "0"))
            if length > MAX_BODY_BYTES:
                return self._send(413, b"request body too large", "text/plain")
            fields = _parse_multipart(self.headers, self.rfile.read(length))
            video = fields.get("video", b"")
            prompt = fields.get("prompt", b"").decode().strip()
            if not video or not prompt:
                return self._send(400, b"video and prompt are required", "text/plain")
            num = lambda k, d: float(fields[k]) if fields.get(k) else d
            with tempfile.TemporaryDirectory() as tmp, _EDIT_LOCK:
                path = os.path.join(tmp, "input.mp4")
                with open(path, "wb") as f:
                    f.write(video)
                gif = run_edit(args, path, prompt, text_cfg=num("text_cfg", 7.5),
                               video_cfg=num("video_cfg", 1.2),
                               noise_correct=num("noise_correct", 0.5),
                               motion_comp=fields.get("motion_comp", b"") != b"",
                               seed=int(num("seed", 0)), out_path=os.path.join(tmp, "out.gif"))
                with open(gif, "rb") as g:
                    data = g.read()
            if self.headers.get("Accept", "").startswith("image/"):
                return self._send(200, data, "image/gif")
            tag = ("<h3>original | edited</h3><img alt='result' "
                   f"src='data:image/gif;base64,{base64.b64encode(data).decode()}'>")
            self._send(200, _render(tag))

        def log_message(self, fmt, *a):  # quiet unless asked
            if args.verbose:
                super().log_message(fmt, *a)

    return Handler


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default="configs/instruct_v2v.yaml")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--scheduler", default="ddpm")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--image-size", type=int, default=384)
    p.add_argument("--num-frames", type=int, default=32)
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--allow-random-weights", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def make_server(args) -> ThreadingHTTPServer:
    return ThreadingHTTPServer((args.host, args.port), make_handler(args))


def main(argv=None):
    args = build_parser().parse_args(argv)
    server = make_server(args)
    print(f"serving on http://{args.host}:{server.server_address[1]}/")
    server.serve_forever()


if __name__ == "__main__":
    main()
