"""HTTP server exposing an InspectionSession to the single-page client.

The endpoint set mirrors the reference tool's button handlers and canvas
interactions (indexing_ui.py:565-1014): load/switch images (incl.
drag-and-drop uploads, :1134-1161), draw base unit + apply indexing
(:2133-2169), exclusion add/modify/delete (:1764-2115), segmentation /
single-unit defect test / test-all / inspection toggle (:2203-2368,
:1411-1469, :1574-1632, :1634-1709), parameter edits with client-side
debounce (:896-904, :1305-1339), grid JSON + masks/CSV persistence
(:2703-2934), and rendered-canvas/thumbnail views (:2383-2542).

Everything is synchronous over one lock: the reference runs all compute on
the Qt main thread inside button handlers; here requests serialize the same
way while the port's engine does the batched work per call on ``device``.

The port of :mod:`tpu_inspect.ui.server`: the same ops, lock and JSON
responses; PNGs come from the port's encoder (:mod:`tpu_inspect_torch.png`),
byte-different from cv2's, pixel-identical.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from tpu_inspect_torch.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect_torch.geometry import grid_boxes
from tpu_inspect_torch.png import encode_png
from tpu_inspect_torch.session import InspectionSession, SessionError

_APP_HTML = os.path.join(os.path.dirname(__file__), "app.html")

CYAN = (0, 255, 255)
MAGENTA = (255, 0, 255)


class UIServer:
    """Owns the session + HTTP server; start() returns the bound port.

    Without a ``session`` it makes one on ``device`` ("cuda" unless the
    caller asks for the CPU); a given session keeps its own device."""

    def __init__(
        self,
        session: InspectionSession | None = None,
        host: str = "127.0.0.1",
        port: int = 0,
        device: str = "cuda",
    ):
        self.session = session or InspectionSession(device=device)
        self.lock = threading.RLock()
        self.host = host
        self._port = port
        self.httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self.selected: int | None = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> int:
        handler = _make_handler(self)
        self.httpd = ThreadingHTTPServer((self.host, self._port), handler)
        self._port = self.httpd.server_address[1]
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()
        return self._port

    @property
    def port(self) -> int:
        return self._port

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self._port}/"

    def stop(self) -> None:
        if self.httpd is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
            self.httpd = None

    # -- state ----------------------------------------------------------------

    def state(self) -> dict:
        s = self.session
        grid = s.grid
        boxes = grid_boxes(grid) if grid is not None else []
        st = s.results() if s.current_path else None
        insp = st.insp if st else None
        out = {
            "images": list(s._order),
            "current": s.current_path,
            "reference": s.reference_path,
            "is_reference": s.is_reference,
            "image_size": (
                [int(s.image.shape[1]), int(s.image.shape[0])]
                if s.current_path
                else None
            ),
            "grid": (
                {**dataclasses.asdict(grid), "num_units": grid.num_units}
                if isinstance(grid, GridParams)
                else ({"num_units": len(boxes)} if grid is not None else None)
            ),
            "boxes": [list(b) for b in boxes],
            "exclusions": list(s.exclusions),
            "seg_params": dataclasses.asdict(s.seg_params),
            "defect_params": dataclasses.asdict(s.defect_params),
            "overlay_mode": s.overlay_mode,
            "inspection_enabled": s.inspection_enabled,
            "selected": self.selected,
            "has_seg": bool(st and st.seg is not None),
            "has_insp": bool(insp is not None),
            "log": s.log.tail(40),
        }
        if insp is not None:
            out["verdicts"] = [bool(v) for v in insp.verdicts]
            out["areas"] = [int(a) for a in insp.areas]
            out["found"] = [bool(v) for v in insp.valid]
        return out

    # -- rendering ------------------------------------------------------------

    def render_png(self, query: dict) -> bytes:
        from tpu_inspect_torch import render

        s = self.session
        img = s.image
        sel_q = query.get("selected", [""])[0]
        selected = int(sel_q) if sel_q not in ("", "none") else None
        if s.grid is None:
            rgb = render._to_rgb(img)
        else:
            st = s.results()
            if s.inspection_enabled and st.insp is not None:
                rgb = render.render_inspection(img, s.grid, st.insp.verdicts)
            else:
                seg_masks = st.seg.masks if st.seg is not None else None
                dmasks = (
                    st.insp.defect_mask_list() if st.insp is not None else None
                )
                mode = query.get("mode", [s.overlay_mode])[0]
                rgb = render.render_canvas(
                    img, s.grid, seg_masks, dmasks, mode, selected
                )
            if (
                query.get("outline", ["0"])[0] == "1"
                and selected is not None
            ):
                rgb = self._composite_outline(rgb, selected)
        return encode_png(rgb)

    def _composite_outline(self, rgb: np.ndarray, selected: int) -> np.ndarray:
        """Cyan erosion-outline preview for the selected unit
        (indexing_ui.py:2544-2618)."""
        from tpu_inspect_torch import render

        s = self.session
        boxes = grid_boxes(s.grid)
        if not (0 <= selected < len(boxes)):
            return rgb
        st = s.results()
        mask = st.seg.masks[selected] if st.seg is not None else None
        res = render.erosion_outline(
            mask, boxes[selected], s.defect_params.erode_px, s.device
        )
        if res is None:
            return rgb
        kind, val = res
        if kind == "rect":
            render._draw_rect_border(rgb, *val, CYAN, 2)
        else:
            x, y, w, h = boxes[selected]
            ys, xs = np.nonzero(val)
            H, W = rgb.shape[:2]
            yy = np.clip(ys + y, 0, H - 1)
            xx = np.clip(xs + x, 0, W - 1)
            rgb[yy, xx] = CYAN
        return rgb

    def _host_crops(self) -> np.ndarray:
        """Host copy of the current crop batch, cached per (image, grid) —
        the thumbnail endpoint is hit once per unit per refresh and must not
        re-gather/transfer the whole batch each time."""
        s = self.session
        key = (s.current_path, s.grid)
        cached = getattr(self, "_thumb_crops", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        crops = s._crops().cpu().numpy()
        self._thumb_crops = (key, crops)
        return crops

    def thumb_png(self, query: dict) -> bytes:
        from tpu_inspect_torch import render

        s = self.session
        idx = int(query.get("idx", ["0"])[0])
        mode = query.get("mode", [s.overlay_mode])[0]
        crops = self._host_crops()
        if not (0 <= idx < crops.shape[0]):
            raise SessionError(f"unit index out of range: {idx}")
        st = s.results()
        seg = st.seg.masks[idx] if st.seg is not None else None
        dm = st.insp.defect_mask_list()[idx] if st.insp is not None else None
        icon = render.thumbnail_icon(crops[idx], seg, dm, mode)
        return encode_png(icon)

    # -- API ops --------------------------------------------------------------

    def api(self, op: str, body: dict) -> dict:
        s = self.session
        if op == "load":
            if "png_base64" in body:  # drag-and-drop upload (:1134-1161)
                from tpu_inspect_torch.imageio import decode_gray

                img = decode_gray(base64.b64decode(body["png_base64"]))
                s.add_image(body["name"], img)
                return {"ok": True, "path": body["name"]}
            s.add_image(body["path"])
            return {"ok": True, "path": body["path"]}
        if op == "switch":
            s.switch_to(body["path"])
            return {"ok": True}
        if op == "indexing":
            base = tuple(int(v) for v in body["base_unit"])
            fields = (
                "units_x", "units_y", "blocks_x", "blocks_y",
                "unit_space_x", "unit_space_y", "block_space_x", "block_space_y",
            )
            kw = {k: int(body.get(k, 0) or 0) for k in fields if k in body}
            grid = GridParams(base_unit=base, **kw)
            if grid.num_units <= 0:
                raise SessionError("grid has zero units")
            n = s.apply_indexing(grid)
            s.log.log(f"Applied indexing: {n} units")
            return {"ok": True, "num_units": n}
        if op == "grid_preview":
            base = tuple(int(v) for v in body["base_unit"])
            fields = (
                "units_x", "units_y", "blocks_x", "blocks_y",
                "unit_space_x", "unit_space_y", "block_space_x", "block_space_y",
            )
            kw = {k: int(body.get(k, 0) or 0) for k in fields if k in body}
            grid = GridParams(base_unit=base, **kw)
            return {"ok": True, "boxes": [list(b) for b in grid_boxes(grid)]}
        if op == "seg_params":
            s.set_seg_params(SegmentationParams(**body).validated())
            return {"ok": True}
        if op == "defect_params":
            s.set_defect_params(DefectParams(**body).validated())
            return {"ok": True}
        if op == "run_segmentation":
            res = s.run_segmentation()
            s.log.log(f"Segmentation complete: {res.masks.shape[0]} units")
            return {"ok": True, "units": int(res.masks.shape[0])}
        if op == "inspection":
            res = s.set_inspection(bool(body["enabled"]))
            out = {"ok": True, "enabled": s.inspection_enabled}
            if res is not None:
                out["ng"] = int(res.verdicts.sum())
            return out
        if op == "test_defect":
            idx = int(body["idx"])
            self.selected = idx
            r = s.test_defect_unit(idx)
            boxes = grid_boxes(s.grid)
            return {
                "ok": True,
                "area": r["area"],
                "verdict": r["verdict"],
                "found": r["found"],
                "zoom_to": list(boxes[idx]),  # client centers at 80% (:1711-1752)
            }
        if op == "test_all":
            res = s.run_inspection()  # :1574-1632 batch loop semantics
            s.exit_inspection(force_overlay_mode="Defect")
            s.log.batch_summary(int(res.valid.sum()), int(res.valid.shape[0]))
            return {"ok": True, "detections": int(res.valid.sum())}
        if op == "auto_update_defect":
            # debounced live param re-run for the selected unit (:1324-1339)
            s.auto_update_defect_unit(int(body["idx"]))
            return {"ok": True}
        if op == "select":
            self.selected = None if body.get("idx") is None else int(body["idx"])
            return {"ok": True, "selected": self.selected}
        if op == "overlay":
            mode = str(body["mode"])
            if mode not in ("None", "Segmentation", "Defect", "Both"):
                raise SessionError(f"unknown overlay mode: {mode}")
            s.overlay_mode = mode
            return {"ok": True, "overlay_mode": mode}
        if op == "exclusion_add":
            idx = s.add_exclusion(body["excl"])
            return {"ok": True, "index": idx}
        if op == "exclusion_modify":
            s.modify_exclusion(int(body["idx"]), body["excl"])
            return {"ok": True}
        if op == "exclusion_delete":
            s.delete_exclusion(int(body["idx"]))
            return {"ok": True}
        if op == "export_grid":
            doc = s.export_grid(body.get("path"))
            return {"ok": True, "grid": doc}
        if op == "import_grid":
            n = s.import_grid(body.get("path") or body["grid"])
            if s.current_path:
                s.run_segmentation()
            return {"ok": True, "boxes": n}
        if op == "export_masks":
            path = s.export_masks(body["dir"])
            return {"ok": True, "csv": path}
        if op == "export_thumbnails":
            n = s.export_thumbnails(body["dir"])
            return {"ok": True, "count": n}
        raise SessionError(f"unknown op: {op}")


def _make_handler(server: UIServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            url = urlparse(self.path)
            query = parse_qs(url.query)
            try:
                with server.lock:
                    if url.path in ("/", "/index.html"):
                        with open(_APP_HTML, "rb") as f:
                            self._send(200, f.read(), "text/html")
                    elif url.path == "/api/state":
                        self._json(server.state())
                    elif url.path == "/api/canvas.png":
                        self._send(200, server.render_png(query), "image/png")
                    elif url.path == "/api/thumb.png":
                        self._send(200, server.thumb_png(query), "image/png")
                    else:
                        self._json({"error": "not found"}, 404)
            except (SessionError, RuntimeError, ValueError, KeyError) as e:
                self._json({"error": str(e)}, 400)

        def do_POST(self):
            url = urlparse(self.path)
            op = url.path.removeprefix("/api/")
            try:
                n = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(n) or b"{}")
                with server.lock:
                    self._json(server.api(op, body))
            except (
                SessionError,
                RuntimeError,
                ValueError,
                KeyError,
                json.JSONDecodeError,
            ) as e:
                self._json({"error": str(e)}, 400)

    return Handler


def main(argv=None):
    """`python -m tpu_inspect_torch.ui.server [image ...] [--grid g.json]
    [--port N] [--device cuda|cpu]`"""
    import argparse

    ap = argparse.ArgumentParser(description="tpu-inspect web UI (PyTorch + CUDA)")
    ap.add_argument("images", nargs="*", help="image files to preload")
    ap.add_argument("--grid", help="grid JSON to import")
    ap.add_argument("--port", type=int, default=8700)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    srv = UIServer(host=args.host, port=args.port, device=args.device)
    for p in args.images:
        srv.session.add_image(p)
    if args.grid:
        srv.session.import_grid(args.grid)
        if srv.session.current_path:
            srv.session.run_segmentation()
    srv.start()
    print(f"tpu-inspect UI at {srv.url} (device {srv.session.device})", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        srv.stop()


if __name__ == "__main__":
    main()
