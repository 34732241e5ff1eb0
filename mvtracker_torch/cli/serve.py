"""Inference server, the counterpart of `mvtracker_tpu/cli/serve.py`: the
model stays resident and answers npz requests over HTTP.

    python -m mvtracker_torch.cli.serve --ckpt_dir exp/ --port 8787 --chunk_frames 24

    POST /track   body = .npz bytes with rgbs [V,T,H,W,3], depths [V,T,H,W],
                  query_points [N,4], intrs [V,T,3,3], extrs [V,T,3,4]
                  -> .npz bytes with traj [T,N,3], vis [T,N]; arrays of
                  any real dtype, widened to fp32 on the device (uint8
                  frames cross to it at a byte a channel)
    GET  /healthz -> JSON: device, input shapes served, request and error counts

The model is the flagship `MVTracker` (fp32), as in the JAX server. Its
weights: `--params_msgpack` (a flax params file, loaded strictly), or the
newest `torch.save` checkpoint of the port's trainer under `--ckpt_dir`, or
seeded random weights with a warning. Requests are served one at a time
under a lock (one card, one queue); `--warmup_shape V T H W N` runs one
scene of that shape (`mvtracker_torch/scene.py`) before serving, so that the
first request does not pay cuDNN's and the kernels' first calls.
`--device` (default cuda) picks the device. Each request logs the time it
waited for the lock apart from the time it was served.

Each request runs in a thread of its own, so a `torch.profiler` sees its
spans when it records every thread (`experimental_config=
torch._C._profiler._ExperimentalConfig(profile_all_threads=True)`): for each
request `mvtracker::serve.wait` (taking the lock), then the predictor's
spans: `mvtracker::predict` with `::upload`, `::support` and the model's
`::forward`, which holds `::upload`, `::encode` (`::encoder`), `::clouds`,
`::feat_init` and one `::window` a window; a window holds one
`::correlation` (`::knn`, `::corr`) and one `::transformer` an iteration,
then `::vis_head` (`mvtracker_torch/utils/observability.py::span`).
"""

from __future__ import annotations

import argparse
import io
import json
import logging
import threading
import time


def make_handler(predictor, stats, lock):
    import numpy as np
    from http.server import BaseHTTPRequestHandler

    from mvtracker_torch.evaluation.evaluator import to_host
    from mvtracker_torch.utils.observability import span

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # through logging
            logging.info("%s " + fmt, self.client_address[0], *args)

        def _reply(self, code, body, ctype):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._reply(404, b"not found", "text/plain")
            with lock:
                body = json.dumps({
                    "device": str(predictor.device),
                    "shapes": len(stats["shapes"]),
                    "requests": stats["requests"],
                    "errors": stats["errors"],
                }).encode()
            return self._reply(200, body, "application/json")

        def do_POST(self):
            if self.path != "/track":
                return self._reply(404, b"not found", "text/plain")
            try:
                n = int(self.headers.get("Content-Length", 0))
                data = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
                # At their stored width: the predictor widens on the device.
                args = tuple(data[k] for k in ("rgbs", "depths", "query_points", "intrs", "extrs"))
                t0 = time.perf_counter()
                with span("serve.wait"):
                    lock.acquire()  # one card: one request at a time; the counts too
                t1 = time.perf_counter()
                try:
                    out = predictor(*args)
                    traj, vis = to_host(out["traj"]), to_host(out["vis"])
                    stats["requests"] += 1
                    stats["shapes"].add((args[0].shape, args[2].shape))
                finally:
                    lock.release()
                dt = time.perf_counter() - t1
                logging.info(
                    "tracked %d pts x %d frames in %.2fs after %.2fs waiting for the card (%.0f pf/s)",
                    traj.shape[1], traj.shape[0], dt, t1 - t0, traj.shape[0] * traj.shape[1] / max(dt, 1e-9),
                )
                buf = io.BytesIO()
                np.savez_compressed(buf, traj=traj, vis=vis)
                return self._reply(200, buf.getvalue(), "application/octet-stream")
            except Exception as e:  # noqa: BLE001 — report it and keep serving
                with lock:
                    stats["errors"] += 1
                logging.exception("request failed")
                return self._reply(400, str(e).encode(), "text/plain")

    return Handler


def build_server(model, host="127.0.0.1", port=8787, **predictor_kwargs):
    """(server, predictor); the caller runs `server.serve_forever()`. Port 0
    takes a free port (`server.server_address`)."""
    from http.server import ThreadingHTTPServer

    from mvtracker_torch.evaluation.predictor import EvaluationPredictor

    predictor = EvaluationPredictor(model, **predictor_kwargs)
    stats = {"requests": 0, "errors": 0, "shapes": set()}
    lock = threading.Lock()
    server = ThreadingHTTPServer((host, port), make_handler(predictor, stats, lock))
    return server, predictor


def load_model(args):
    """The flagship model on `args.device` with the weights the flags name."""
    from mvtracker_torch.convert import load_release, random_state_dict
    from mvtracker_torch.models.mvtracker import MVTracker
    from mvtracker_torch.training import step as step_lib
    from mvtracker_torch.training.train import TrainConfig, Trainer

    model = MVTracker(device=args.device).eval()
    if args.params_msgpack:
        return load_release(args.params_msgpack, model)
    if args.ckpt_dir:
        trainer = Trainer(model, TrainConfig(exp_dir=args.ckpt_dir))
        if trainer.latest_step() is not None:
            _, step = trainer.restore_latest(step_lib.init_state(model, trainer.optimizer))
            logging.info("loaded checkpoint step %d", step)
            return model
    logging.warning("no checkpoint given: serving a randomly initialized model")
    model.load_state_dict(random_state_dict(model, seed=0))
    return model


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8787)
    parser.add_argument("--ckpt_dir", default=None, help="experiment dir with checkpoints")
    parser.add_argument("--params_msgpack", default=None, help="flax params file")
    parser.add_argument("--chunk_frames", type=int, default=None)
    parser.add_argument("--iters", type=int, default=6)
    parser.add_argument("--grid_size", type=int, default=0)
    parser.add_argument("--interp_shape", type=int, nargs=2, default=None)
    parser.add_argument("--warmup_shape", type=int, nargs=5, default=None, metavar=("V", "T", "H", "W", "N"),
                        help="run one scene of this shape at startup")
    parser.add_argument("--device", default="cuda", help="torch device to serve on")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")

    import numpy as np
    import torch

    from mvtracker_torch.scene import make_scene

    model = load_model(args)
    server, predictor = build_server(
        model, host=args.host, port=args.port,
        interp_shape=tuple(args.interp_shape) if args.interp_shape else None,
        grid_size=args.grid_size, n_iters=args.iters, chunk_frames=args.chunk_frames, device=args.device,
    )
    if args.warmup_shape:
        v, t, h, w, n = args.warmup_shape
        logging.info("warm-up request of shape V=%d T=%d H=%d W=%d N=%d ...", v, t, h, w, n)
        with torch.no_grad():
            predictor(*make_scene(np.random.default_rng(0), v, t, h, w, n))
        logging.info("warm-up done")
    logging.info("serving on http://%s:%d", *server.server_address[:2])
    server.serve_forever()


if __name__ == "__main__":
    main()
