"""Headless CLI: the engine's button handlers without the buttons.

The port of :mod:`tpu_inspect.cli`, with the same subcommands, flags and
outputs, on ``--device cuda`` (the default) or ``--device cpu``::

  python -m tpu_inspect_torch.cli segment  --grid grid.json --image mold.tif --out out/
  python -m tpu_inspect_torch.cli inspect  --grid grid.json --image a.tif b.tif --out out/
  python -m tpu_inspect_torch.cli gridgen  --base 251,232,316,315 --units 4x6 \\
      --blocks 2x1 --unit-space 133,136 --block-space 252,0 --out grid.json
  python -m tpu_inspect_torch.cli stream   --grid grid.json frame0.tif frame1.tif ...
  python -m tpu_inspect_torch.cli bench
  python -m tpu_inspect_torch.cli profile
  python -m tpu_inspect_torch.cli doctor
  python -m tpu_inspect_torch.cli ui --grid grid.json mold.tif

`inspect` treats the first image as the reference capture (anchors
recorded) and later images as production captures (exclusions re-aligned),
matching the reference's multi-image workflow, and prints one JSON report.
`stream` is the deployment-shaped flow: the decode-ahead native loader and
pipelined device dispatch, one JSONL verdict line per frame. `bench` runs
the headline form of the port's benchmark runner
(:func:`tpu_inspect_torch.bench.main`) on the card; like the JAX package's,
it takes no device flag.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _parse_pair(s: str, sep: str) -> tuple[int, int]:
    a, b = s.split(sep)
    return int(a), int(b)


def _seg_params(args):
    from tpu_inspect_torch.config import SegmentationParams

    return SegmentationParams(
        method=args.seg_method,
        gaussian_blur=args.gaussian_blur,
        morph_kernel=args.morph_kernel,
        adapt_block=args.adapt_block,
        adapt_C=args.adapt_c,
    )


def _defect_params(args):
    from tpu_inspect_torch.config import DefectParams

    return DefectParams(
        method=args.defect_method,
        threshold=args.threshold,
        min_area=args.min_area,
        erode_px=args.erode_px,
    )


def _add_param_flags(p):
    p.add_argument("--seg-method", choices=["otsu", "adaptive"], default="otsu")
    p.add_argument("--gaussian-blur", type=int, default=3)
    p.add_argument("--morph-kernel", type=int, default=3)
    p.add_argument("--adapt-block", type=int, default=51)
    p.add_argument("--adapt-c", type=int, default=10)
    p.add_argument("--defect-method", choices=["threshold", "canny"], default="threshold")
    p.add_argument("--threshold", type=int, default=24)
    p.add_argument("--min-area", type=int, default=20)
    p.add_argument("--erode-px", type=int, default=6)


def _add_device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="cuda (default; the hand-written kernels) or cpu (their plain versions)")


def cmd_gridgen(args):
    from tpu_inspect_torch.config import GridParams
    from tpu_inspect_torch.geometry import grid_boxes
    from tpu_inspect_torch.persistence import GridDocument, grid_metadata, save_grid

    bx, by, bw, bh = (int(v) for v in args.base.split(","))
    ux, uy = _parse_pair(args.units, "x")
    blx, bly = _parse_pair(args.blocks, "x")
    sux, suy = _parse_pair(args.unit_space, ",")
    sbx, sby = _parse_pair(args.block_space, ",")
    grid = GridParams(
        base_unit=(bx, by, bw, bh),
        units_x=ux, units_y=uy, blocks_x=blx, blocks_y=bly,
        unit_space_x=sux, unit_space_y=suy,
        block_space_x=sbx, block_space_y=sby,
    )
    iw, ih = (None, None)
    if args.image_size:
        iw, ih = _parse_pair(args.image_size, "x")
    doc = GridDocument(boxes=grid_boxes(grid), metadata=grid_metadata(grid, iw, ih))
    save_grid(doc, args.out)
    print(f"wrote {len(doc.boxes)} boxes to {args.out}")


def _load_session(args):
    from tpu_inspect_torch.session import InspectionSession

    sess = InspectionSession(
        seg_params=_seg_params(args), defect_params=_defect_params(args),
        device=args.device,
    )
    for path in args.image:
        sess.add_image(path)
    sess.switch_to(args.image[0])
    n = sess.import_grid(args.grid)
    print(f"grid: {n} units; reference image: {args.image[0]}", file=sys.stderr)
    return sess


def cmd_segment(args):
    sess = _load_session(args)
    sess.run_segmentation()
    if args.out:
        csv_path = sess.export_masks(args.out)
        print(f"masks + {csv_path} written")
    if args.thumbnails:
        n = sess.export_thumbnails(args.thumbnails)
        print(f"exported {n} thumbnails to {args.thumbnails}")


def cmd_inspect(args):
    sess = _load_session(args)
    report = {}
    for path in args.image:
        sess.switch_to(path)
        insp = sess.run_inspection()
        report[path] = {
            "ng_units": [int(i) for i in np.nonzero(insp.verdicts)[0]],
            "ng_count": int(insp.verdicts.sum()),
            "unit_count": int(insp.verdicts.shape[0]),
            "areas": {str(i): int(a) for i, a in enumerate(insp.areas) if insp.valid[i]},
        }
        print(
            f"{path}: {report[path]['ng_count']}/{report[path]['unit_count']} units NG",
            file=sys.stderr,
        )
        stem = os.path.splitext(os.path.basename(path))[0]
        if args.out:
            sess.export_masks(os.path.join(args.out, stem))
        if args.thumbnails:
            sess.export_thumbnails(os.path.join(args.thumbnails, stem))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "inspection.json"), "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report))


def cmd_stream(args):
    """Inline inspection of a capture stream (file list), pipelined.

    The deployment-shaped flow: decode-ahead via the native loader, the
    device pipeline dispatched ahead of results, one JSONL line per frame.
    Anchors come from the grid JSON (v2 exclusion_alignment) when present;
    otherwise, when the grid has exclusions, the first frame is treated as
    the reference capture and its centroids anchor the rest of the stream
    (the reference tool's first-image-is-reference rule,
    indexing_ui.py:1196-1208)."""
    from itertools import chain

    from tpu_inspect_torch.engine import segment_units
    from tpu_inspect_torch.imageio import load_gray, load_gray_stream
    from tpu_inspect_torch.persistence import load_grid
    from tpu_inspect_torch.streaming import stream_inspect
    from tpu_inspect_torch.synthetic import crop_units

    doc = load_grid(args.grid)
    grid = doc.grid_params
    if grid is None:
        raise SystemExit(f"grid JSON {args.grid} has no usable geometry")

    frames = list(args.frames)
    anchors = dict(doc.ref_centroids)
    ref = None
    if not anchors and doc.exclusions:
        ref = load_gray(frames[0])
        anchors = segment_units(
            crop_units(ref, grid), _seg_params(args), device=args.device
        ).centroid_dict()
        print(f"anchors recorded from reference frame {frames[0]}", file=sys.stderr)

    # frame 0 decoded for anchors feeds the stream directly (no re-decode);
    # the rest come through the native decode-ahead loader
    if ref is not None:
        images = chain([ref], load_gray_stream(frames[1:], threads=args.decode_threads))
    else:
        images = load_gray_stream(frames, threads=args.decode_threads)

    total_ng = 0
    for res in stream_inspect(
        images,
        grid,
        _seg_params(args),
        _defect_params(args),
        exclusions=doc.exclusions,
        ref_centroids=anchors or None,
        prefetch=args.prefetch,
        device=args.device,
    ):
        total_ng += res.ng_count
        print(
            json.dumps({
                "frame": frames[res.index],
                "index": res.index,
                "ng_count": res.ng_count,
                "unit_count": int(res.verdicts.shape[0]),
                "ng_units": [int(i) for i in np.nonzero(res.verdicts)[0]],
            }),
            flush=True,
        )
    print(f"stream done: {len(frames)} frames, {total_ng} unit NGs", file=sys.stderr)


def cmd_profile(args):
    """Device-profile the standard workload; print per-kernel totals.

    Runs one capture's program (``engine._inspect_image_device``) on the
    reference sample workload (48 units of 316x315 on 4096x3000) under
    ``torch.profiler`` and prints the device time per kernel, copy and op
    (:mod:`tpu_inspect_torch.utils.profile`)."""
    import torch

    from tpu_inspect_torch import engine
    from tpu_inspect_torch.device import resolve_device
    from tpu_inspect_torch.kernels import build, error_flag
    from tpu_inspect_torch.synthetic import standard_workload
    from tpu_inspect_torch.utils.profile import profile_device

    dev = resolve_device(args.device)
    wl = standard_workload()
    image = torch.from_numpy(wl["image"]).to(dev)
    origins = torch.from_numpy(wl["origins"]).to(dev)
    seg, defect = _seg_params(args).validated(), _defect_params(args).validated()

    err = error_flag(dev)

    def run():
        return engine._inspect_image_device(
            image, origins, wl["unit_hw"], seg, defect, wl["exclusions"], None, True, True,
            err,
        )

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"profiling on {name} ...", file=sys.stderr)
    prof = profile_device(run, iters=args.iters)
    build.check_bounded("profile", err)
    if not prof.rows:
        print(f"no device time recorded on {dev}: run on the card (--device cuda) for "
              "per-kernel device time", file=sys.stderr)
        return
    print(f"device time: {prof.busy_ms:.2f} ms/iter over {args.iters} iters "
          f"(wall {prof.wall_ms:.2f} ms/iter under the profiler)")
    for key, ms, count in prof.rows[: args.top]:
        print(f"  {ms:8.3f} ms  x{count:g}  {key}")


def cmd_bench(args):
    from tpu_inspect_torch import bench

    bench.main()


def cmd_ui(args):
    from tpu_inspect_torch.ui.server import main as ui_main

    argv = list(args.images)
    if args.grid:
        argv += ["--grid", args.grid]
    argv += ["--port", str(args.port), "--host", args.host, "--device", args.device]
    ui_main(argv)


def cmd_doctor(args):
    """Deployment diagnostics: the card, the kernel library's build, the
    route gates and native IO."""
    import torch

    from tpu_inspect_torch import engine, native
    from tpu_inspect_torch.kernels import build
    from tpu_inspect_torch.ops.blob import blob_filter_fits
    from tpu_inspect_torch.ops.fused import seg_tail_fits

    cuda = torch.cuda.is_available()
    if cuda:
        print(f"devices: {torch.cuda.device_count()} x cuda ({torch.cuda.get_device_name(0)})")
    else:
        print("devices: UNAVAILABLE (torch.cuda.is_available() is false)")
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}")
    try:
        nvcc = build.find_nvcc()
    except RuntimeError:
        nvcc = None
    if cuda and nvcc and args.device != "cpu":
        build.lib()
    lib = build.library_path()
    print(f"kernel library: {lib.name} from {len(build.sources())} sources, "
          f"{'built' if lib.exists() else 'not built'}; nvcc: {nvcc or 'not found'}")
    print(f"chain flag (TPU_INSPECT_ENABLE_CHAIN): {engine._ENABLE_CHAIN}")
    for shape in ((48, 315, 316), (1, 3000, 4096)):
        h, w = shape[1:]
        print(f"gate seg_tail_fits{shape}: {seg_tail_fits(h, w)}")
        print(f"gate blob_filter_fits{shape}: {blob_filter_fits(h, w)}")
        print(f"gate _whole_route{shape}: {engine._whole_route(h, w)}")
    v = native.version()
    print("native io: " + (v if v else "unavailable (cv2 fallback)"))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpu-inspect-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gridgen", help="generate a grid JSON from indexing params")
    g.add_argument("--base", required=True, help="x,y,w,h of the base unit")
    g.add_argument("--units", default="1x1")
    g.add_argument("--blocks", default="1x1")
    g.add_argument("--unit-space", default="0,0")
    g.add_argument("--block-space", default="0,0")
    g.add_argument("--image-size", default=None, help="WxH")
    g.add_argument("--out", required=True)
    g.set_defaults(fn=cmd_gridgen)

    for name, fn in [("segment", cmd_segment), ("inspect", cmd_inspect)]:
        p = sub.add_parser(name)
        p.add_argument("--grid", required=True)
        p.add_argument("--image", nargs="+", required=True)
        p.add_argument("--out", default=None)
        p.add_argument(
            "--thumbnails",
            default=None,
            metavar="DIR",
            help="also export per-unit crop PNGs (unit_%%04d.png) to DIR",
        )
        _add_param_flags(p)
        _add_device_flag(p)
        p.set_defaults(fn=fn)

    s = sub.add_parser(
        "stream", help="pipelined inline inspection of a frame stream (JSONL output)"
    )
    s.add_argument("--grid", required=True)
    s.add_argument("frames", nargs="+", help="capture frames, in order")
    s.add_argument("--prefetch", type=int, default=2, help="device dispatches kept in flight")
    s.add_argument("--decode-threads", type=int, default=3,
                   help="native decode worker threads")
    _add_param_flags(s)
    _add_device_flag(s)
    s.set_defaults(fn=cmd_stream)

    b = sub.add_parser("bench", help="run the standard benchmark on the card")
    b.set_defaults(fn=cmd_bench)

    pr = sub.add_parser(
        "profile", help="device-profile the standard workload (per-kernel table)"
    )
    pr.add_argument("--iters", type=int, default=8)
    pr.add_argument("--top", type=int, default=15)
    _add_param_flags(pr)
    _add_device_flag(pr)
    pr.set_defaults(fn=cmd_profile)

    d = sub.add_parser(
        "doctor", help="print the card, kernel build, route gates and native-IO status"
    )
    _add_device_flag(d)
    d.set_defaults(fn=cmd_doctor)

    u = sub.add_parser("ui", help="serve the interactive web client")
    u.add_argument("images", nargs="*", help="image files to preload")
    u.add_argument("--grid", default=None, help="grid JSON to import")
    u.add_argument("--port", type=int, default=8700)
    u.add_argument("--host", default="127.0.0.1")
    _add_device_flag(u)
    u.set_defaults(fn=cmd_ui)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
