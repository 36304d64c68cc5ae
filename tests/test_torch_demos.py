"""The port's demos (insv2v_torch.apps.gradio_demo and web_demo) on the CPU,
at the tiny YAML of tests/test_apps.py with ``--device cpu``: the gradio
front end's exit without gradio, the shared ``run_edit`` handler against a
direct ``VideoEditor`` call on the same frames and seed (the same GIF, to
the byte), and the web demo served on a free port (the form, a multipart
edit answered inline or as a raw GIF, 400, 404, 413). Without a GPU the
handler raises unless asked for the CPU."""

import base64
import http.client
import re
import sys
import threading
import types

import numpy as np
import pytest
import torch

from insv2v_torch.apps import gradio_demo, web_demo
from insv2v_torch.apps.edit_video import make_editor
from insv2v_torch.models.clip_text import ClipTextConfig
from insv2v_torch.utils import media
from test_apps import write_tiny_config
from test_torch_apps import make_video


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread per op while this module runs, as the other
    port test modules do: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def demo_args(tmp_path, monkeypatch):
    """The demos' flags at the tiny YAML (a one-layer CLIP text model at its
    768 width), 4 frames at 32x32, DDPM 2 steps, on the CPU; a fresh lazy
    editor for each test."""
    monkeypatch.setattr(ClipTextConfig, "vit_l_14", classmethod(
        lambda cls: cls(vocab_size=49408, hidden_size=768, num_layers=1, num_heads=4,
                        intermediate_size=32)))
    monkeypatch.delenv("INSV2V_RAFT_WEIGHTS", raising=False)
    monkeypatch.setattr(gradio_demo, "_EDITOR", None)
    argv = ["--config", write_tiny_config(tmp_path), "--allow-random-weights",
            "--image-size", "32", "--num-frames", "4", "--steps", "2", "--device", "cpu"]
    return argv, str(make_video(tmp_path / "in.mp4", n=10, hw=(40, 48)))


def test_gradio_main_exits_without_gradio(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)  # import gradio -> ImportError
    with pytest.raises(SystemExit, match="gradio is not installed"):
        gradio_demo.main(["--allow-random-weights", "--device", "cpu"])


@pytest.mark.parametrize("motion_comp", [False, True])
def test_run_edit_equals_a_direct_editor_call(tmp_path, demo_args, motion_comp):
    argv, video = demo_args
    args = gradio_demo.build_parser().parse_args(argv)
    out = gradio_demo.run_edit(args, video, "make it snowy", text_cfg=6.0, video_cfg=1.5,
                               noise_correct=0.5, motion_comp=motion_comp, seed=3,
                               out_path=str(tmp_path / "demo.gif"))
    gif = media.load_gif(out)
    assert gif.shape == (4, 32, 64, 3)

    from insv2v_torch.data.datasets import SingleVideoDataset
    from insv2v_torch.utils.flow import get_flow_estimator

    frames = SingleVideoDataset(video, sampling_fps=8, num_frames=4,
                                output_size=(32, 32))[0]["frames"]
    editor = make_editor(args.config, None, "ddpm", 2, True, "cpu")
    edited = editor(frames, "make it snowy", text_cfg=6.0, video_cfg=1.5, noise_correct_step=0.5,
                    use_motion_compensation=motion_comp,
                    flow_estimator=get_flow_estimator("auto", device="cpu") if motion_comp
                    else None, seed=3)
    want = str(tmp_path / "direct.gif")
    media.save_gif(media.concat_videos([frames, edited]), want)
    np.testing.assert_array_equal(gif, media.load_gif(want))
    assert gradio_demo.get_editor(args) is gradio_demo.get_editor(args)  # built once


def test_run_edit_without_a_gpu_needs_device_cpu(demo_args):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    argv, video = demo_args
    args = gradio_demo.build_parser().parse_args(argv[:-2])  # no --device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gradio_demo.run_edit(args, video, "make it snowy", motion_comp=False)


# --- the web demo ------------------------------------------------------------------

def multipart(fields):
    """{name: str or (filename, bytes)} -> (content type, body)."""
    boundary = "insv2v-test-boundary"
    parts = []
    for name, value in fields.items():
        if isinstance(value, tuple):
            head = (f'Content-Disposition: form-data; name="{name}"; filename="{value[0]}"\r\n'
                    "Content-Type: application/octet-stream")
            data = value[1]
        else:
            head, data = f'Content-Disposition: form-data; name="{name}"', value.encode()
        parts.append(f"--{boundary}\r\n{head}\r\n\r\n".encode() + data + b"\r\n")
    body = b"".join(parts) + f"--{boundary}--\r\n".encode()
    return f"multipart/form-data; boundary={boundary}", body


@pytest.fixture
def served(demo_args):
    argv, video = demo_args
    server = web_demo.make_server(web_demo.build_parser().parse_args(argv + ["--port", "0"]))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]

    def request(method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        out = types.SimpleNamespace(status=resp.status, type=resp.getheader("Content-Type"),
                                    body=resp.read())
        conn.close()
        return out

    yield request, open(video, "rb").read()
    server.shutdown()
    server.server_close()
    thread.join(timeout=10)


def test_web_demo_form_and_errors(served):
    request, video = served
    page = request("GET", "/")
    assert page.status == 200 and b'action="/edit"' in page.body
    assert b"make it a snowy scene" in page.body  # the shared examples
    assert request("GET", "/nowhere").status == 404
    assert request("POST", "/elsewhere", body=b"").status == 404
    ctype, body = multipart({"prompt": "make it snowy"})
    assert request("POST", "/edit", body, {"Content-Type": ctype}).status == 400
    ctype, body = multipart({"video": ("in.mp4", video), "prompt": "  "})
    assert request("POST", "/edit", body, {"Content-Type": ctype}).status == 400


def test_web_demo_refuses_a_large_body_before_reading_it(served):
    request, _ = served
    conn_headers = {"Content-Length": str(web_demo.MAX_BODY_BYTES + 1),
                    "Content-Type": "multipart/form-data; boundary=x"}
    # the header alone: the server answers without waiting for the body
    resp = request("POST", "/edit", None, conn_headers)
    assert resp.status == 413


def test_web_demo_edits_inline_and_raw(served, tmp_path):
    request, video = served
    ctype, body = multipart({"video": ("in.mp4", video), "prompt": "make it snowy",
                             "text_cfg": "6.0", "seed": "3"})
    page = request("POST", "/edit", body, {"Content-Type": ctype})
    assert page.status == 200 and page.type.startswith("text/html")
    inline = base64.b64decode(re.search(rb"data:image/gif;base64,([A-Za-z0-9+/=]+)",
                                        page.body).group(1))
    raw = request("POST", "/edit", body, {"Content-Type": ctype, "Accept": "image/gif"})
    assert raw.status == 200 and raw.type == "image/gif"
    assert raw.body == inline  # the same edit: same frames, seed and weights
    (tmp_path / "answer.gif").write_bytes(raw.body)
    assert media.load_gif(str(tmp_path / "answer.gif")).shape == (4, 32, 64, 3)
