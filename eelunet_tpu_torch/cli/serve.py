"""Serve a checkpoint over HTTP with dynamic micro-batching
(counterpart of ``eelunet_tpu/cli/serve.py``).

    python -m eelunet_tpu_torch.cli.serve --model_type eelunet \\
        --checkpoint eelunet.npz --image_size 512 --set model.dtype=bfloat16 \\
        --port 8500 --max_batch 16 --window_ms 5

``--checkpoint`` is an upstream-layout state dict of the ``--model_type``
family (any of the seven): the ``.npz`` (or ``.pth``) that ``python -m
eelunet_tpu.cli.export_torch --numpy`` writes from a JAX checkpoint, a best
tag of the port's ``cli.train``, or a reference ``.pth``; a full snapshot;
or a slim checkpoint (``cli.prune --physical``), served by its slim module.
``--quantize int8`` serves the W8A8 model (``quantize.py``). ``--artifact
DIR`` serves a ``cli.export`` artifact instead, with no model code, through
the same micro-batcher. Protocol and batching semantics:
``eelunet_tpu_torch/serving.py``.

With more than one card, or ``--set mesh.data_axis=N``, each batch is split
across the cards (``Predictor(mesh=...)``, one replica per card; the bucket
rounds up to a multiple of the data size); ``/v1/stats`` reports
``data_size``. ``--set mesh.data_axis=-1`` takes every card.
"""

from __future__ import annotations

from eelunet_tpu_torch.cli.common import base_parser, load_config


def _ckpt_fingerprint(path):
    """(mtime_ns, size) of the checkpoint file; (0, 0) while it is absent."""
    import os

    try:
        st = os.stat(path)
    except FileNotFoundError:
        return (0, 0)
    return (st.st_mtime_ns, st.st_size)


def start_checkpoint_watcher(service, checkpoint: str, interval_s: float):
    """Poll ``checkpoint`` and hot-swap weights when it changes (the
    --reload_watch flag). Skips a poll while the file is still changing
    between two consecutive reads (a write in progress)."""
    import threading
    import time

    def loop():
        last = _ckpt_fingerprint(checkpoint)
        while True:
            time.sleep(interval_s)
            now = _ckpt_fingerprint(checkpoint)
            if now == last or now[1] == 0:
                continue
            settle = _ckpt_fingerprint(checkpoint)
            if settle != now:
                continue  # still being written; reload on a later poll
            try:
                out = service.reload_checkpoint(checkpoint)
                print(f"[reload_watch] weights reloaded ({out['reloads']} total)")
                last = now
            except Exception as e:  # keep serving old weights; retry later
                print(f"[reload_watch] reload failed, keeping old weights: {e}")

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    return t


def main(argv=None):
    p = base_parser("Serve segmentation over HTTP (micro-batched)")
    p.add_argument("--checkpoint", type=str, default="",
                   help="upstream-layout state dict (.npz or .pth)")
    p.add_argument("--artifact", type=str, default="",
                   help="serve a cli.export artifact dir instead of a checkpoint "
                   "(no model code needed)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8500)
    p.add_argument("--max_batch", type=int, default=16)
    p.add_argument("--window_ms", type=float, default=5.0)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--quantize", type=str, default="", choices=["", "int8"],
                   help="int8: W8A8 dynamic-scale convs and dots (eelunet_tpu_torch.quantize)")
    p.add_argument("--tile", type=int, default=0,
                   help="serve at NATIVE input resolution via fixed-shape "
                   "sliding windows of this size (0 = resize to image_size)")
    p.add_argument("--tile_overlap", type=int, default=64)
    p.add_argument("--max_pending", type=int, default=128,
                   help="admission bound on pending work (queued + in "
                   "flight); beyond it requests shed with 503 + Retry-After "
                   "(0 = unbounded)")
    p.add_argument("--deadline_ms", type=float, default=0.0,
                   help="default per-request deadline; a request still "
                   "queued past it fails with 504 (0 = none; per-request "
                   "override via ?deadline_ms=)")
    p.add_argument("--reload_watch", type=float, default=0.0,
                   help="poll --checkpoint every N seconds and hot-swap the "
                   "weights when the file changes (also available on demand "
                   "via POST /v1/reload)")
    args = p.parse_args(argv)
    cfg = load_config(args)

    from eelunet_tpu_torch.serving import SegmentationService, make_server

    d = cfg.data
    if args.artifact:
        if args.quantize:
            p.error("--quantize applies when a model is built; exported artifacts are "
                    "already traced: re-export with --quantize or serve from a checkpoint")
        if args.tile:
            p.error("--tile needs a checkpoint-backed Predictor; exported artifacts are "
                    "fixed-shape programs")
        if args.reload_watch > 0:
            p.error("--reload_watch needs a checkpoint-backed Predictor")
        if cfg.mesh.data_axis > 1:
            p.error("an exported artifact runs on one device; serve a checkpoint to split "
                    "batches across cards (mesh.data_axis)")
        from eelunet_tpu_torch.export import ExportedModel, read_meta
        from eelunet_tpu_torch.registry import resolve_device

        # The programs run on the device they were exported for; serve one
        # only where this call asks for that device.
        device = resolve_device(args.device)
        exported_for = read_meta(args.artifact)["platforms"][0]
        if exported_for != device.type:
            p.error(f"{args.artifact} was exported for {exported_for!r}; this call asks for "
                    f"--device {args.device!r}: re-export it there or pass --device "
                    f"{exported_for}")
        predictor = ExportedModel(args.artifact)
        name = predictor.meta["model"]
        image_size = tuple(predictor.meta["image_size"])
        device, dtype = predictor.device, "exported"
        # coalesced batches cannot exceed the largest exported bucket
        args.max_batch = min(args.max_batch, max(predictor.meta["batch_sizes"]))
    else:
        if not args.checkpoint:
            p.error("one of --checkpoint or --artifact is required")
        from eelunet_tpu_torch.cli.common import serving_mesh
        from eelunet_tpu_torch.inference import Predictor
        from eelunet_tpu_torch.registry import resolve_device

        # batch-parallel serving over the cards (the JAX CLI's rule)
        mesh = serving_mesh(cfg, resolve_device(args.device))
        predictor = Predictor(
            cfg.model, checkpoint=args.checkpoint, threshold=args.threshold,
            normalize_mean=tuple(d.normalize_mean), normalize_std=tuple(d.normalize_std),
            mesh=mesh, tta=cfg.tta, quantize=args.quantize or None, device=args.device,
        )
        name, image_size = cfg.model.name, d.image_size
        device, dtype = ",".join(map(str, predictor.devices)), cfg.model.dtype
    service = SegmentationService(
        predictor, image_size,
        max_batch=args.max_batch, window_ms=args.window_ms,
        threshold=args.threshold,
        tile=args.tile, tile_overlap=args.tile_overlap,
        max_pending=args.max_pending, deadline_ms=args.deadline_ms,
    )
    if args.reload_watch > 0:
        start_checkpoint_watcher(service, args.checkpoint, args.reload_watch)
    server = make_server(service, name, args.host, args.port)
    h, w = image_size
    print(f"serving {name} at {h}x{w} on "
          f"http://{server.server_address[0]}:{server.server_address[1]} "
          f"(device={device}, dtype={dtype}, "
          f"max_batch={args.max_batch}, window={args.window_ms}ms)", flush=True)
    # Orchestrators stop containers with SIGTERM: convert it to the same
    # graceful path as ^C (stop accepting, drain the batcher queue).
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        service.close()


if __name__ == "__main__":
    main()
