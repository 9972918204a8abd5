"""Live splat viewer: stdlib HTTP server + embedded WebGL2 client.

Counterpart of fusionsense_tpu/viewer/server.py. The reference ships
nerfstudio's viser viewer (dn_config.py:76-77, vis="viewer+wandb"); this
is a viewer with no external dependency: a background http.server thread
serves

  GET /            the embedded WebGL2 Gaussian-splat client (viewer.html)
  GET /splats.bin  the CURRENT model packed in the standard 32-byte .splat
                   record (antimatter15 layout: pos f32x3, scale f32x3,
                   rgba u8x4, quat u8x4) — also readable by any external
                   .splat viewer
  GET /state       JSON {step, num_splats, version, metrics}

The client polls /state and refetches /splats.bin when `version` changes,
so a training run is watchable live; `ViewerCallback` plugs into
Trainer.extra_callbacks and snapshots the store at chunk boundaries of
Trainer.run (a host read, so never inside run_fused's intervals). The
packing is host numpy on the fields fetched from the device, the JAX
package's operations in its order, so both packages give the same bytes
for the same state.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np

from fusionsense_tpu_torch.device import host


def pack_splats(means, scales, colors_rgb, opacities, quats,
                max_splats: int | None = None) -> bytes:
    """Pack activated per-splat arrays into the 32-byte .splat layout.

    means/scales (N,3) f32; colors_rgb (N,3) in [0,1]; opacities (N,) in
    (0,1); quats (N,4) wxyz normalized.
    """
    n = len(means)
    if max_splats is not None and n > max_splats:
        keep = np.argsort(-np.asarray(opacities))[:max_splats]
        means, scales = means[keep], scales[keep]
        colors_rgb, opacities, quats = colors_rgb[keep], opacities[keep], quats[keep]
        n = max_splats
    rec = np.empty((n, 32), np.uint8)
    rec[:, 0:12] = np.asarray(means, np.float32).view(np.uint8).reshape(n, 12)
    rec[:, 12:24] = np.asarray(scales, np.float32).view(np.uint8).reshape(n, 12)
    rgba = np.concatenate(
        [np.clip(colors_rgb, 0, 1) * 255,
         np.clip(np.asarray(opacities)[:, None], 0, 1) * 255], axis=1)
    rec[:, 24:28] = rgba.astype(np.uint8)
    q = np.asarray(quats, np.float32)
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-9)
    rec[:, 28:32] = np.clip(q * 128 + 128, 0, 255).astype(np.uint8)
    return rec.tobytes()


def pack_state(state, max_splats: int | None = None) -> bytes:
    """GaussianState -> .splat bytes (alive splats only, activated). The
    raw fields come to the host first and are activated there: an exp on
    the device can differ from numpy's in the last bit, which moves a
    scale's bytes or flips a colour's rounding."""
    alive = host(state.alive)
    means = host(state.means)[alive]
    scales = np.exp(host(state.log_scales))[alive]
    op = 1.0 / (1.0 + np.exp(-host(state.logit_opacities)))[alive]
    quats = host(state.quats)[alive]
    sh0 = host(state.features_dc)[alive]
    rgb = np.clip(sh0 * 0.2820947917738781 + 0.5, 0, 1)
    return pack_splats(means, scales, rgb, op, quats, max_splats)


class _Handler(BaseHTTPRequestHandler):
    server_version = "fs-viewer/1.0"

    def log_message(self, *a):   # quiet
        pass

    def _send(self, code, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.send_header("Access-Control-Allow-Origin", "*")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv: SplatViewerServer = self.server.owner   # type: ignore
        if self.path in ("/", "/index.html"):
            html = (Path(__file__).parent / "viewer.html").read_bytes()
            self._send(200, html, "text/html; charset=utf-8")
        elif self.path.startswith("/splats.bin"):
            with srv._lock:
                blob = srv._blob
            self._send(200, blob, "application/octet-stream")
        elif self.path.startswith("/state"):
            with srv._lock:
                st = dict(srv._state)
            self._send(200, json.dumps(st).encode(), "application/json")
        else:
            self._send(404, b"not found", "text/plain")


class SplatViewerServer:
    """Background viewer server; update() swaps in a new splat snapshot."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7007):
        self._lock = threading.Lock()
        self._blob = b""
        self._state = {"step": 0, "num_splats": 0, "version": 0,
                       "metrics": {}}
        self.httpd = ThreadingHTTPServer((host, port), _Handler)
        self.httpd.owner = self   # type: ignore
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.httpd.server_address[0]}:{self.port}/"

    def update(self, blob: bytes, step: int = 0, metrics: dict | None = None):
        with self._lock:
            self._blob = blob
            self._state = {"step": step, "num_splats": len(blob) // 32,
                           "version": self._state["version"] + 1,
                           "metrics": metrics or {}}

    def update_from_state(self, state, step: int = 0,
                          metrics: dict | None = None,
                          max_splats: int | None = 400_000):
        self.update(pack_state(state, max_splats), step, metrics)

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class ViewerCallback:
    """Trainer.extra_callbacks hook: snapshot the store every `every` steps
    (a host transfer of the whole store). Returns None: it changes nothing,
    so it never asks the trainer to recompact."""

    def __init__(self, server: SplatViewerServer, every: int = 100):
        self.server = server
        self.every = every
        self._last = -1

    def __call__(self, trainer):
        if trainer.step // self.every == self._last // self.every and \
           self._last >= 0:
            self._last = trainer.step
            return
        self._last = trainer.step
        metrics = dict(trainer.history[-1]) if trainer.history else {}
        self.server.update_from_state(trainer.gaussians, trainer.step,
                                      metrics)
