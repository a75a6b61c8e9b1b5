"""HTTP place-recognition server over the PlaceIndex (counterpart of
``epcnet_tpu/cli/serve.py``, the same JSON API, status codes and flags).

  python -m epcnet_torch.cli.serve --log_dir log [--host 127.0.0.1]
      [--port 8476] [--k 25] [--max_wait_ms 2] [--embed_batch 32]
      [--db saved_index.npz] [--save_on_exit saved_index.npz]
      [--warmup_points 0|N] [--quantize none|int8]
      [--sync_mode blocking|background] [--sync_chunk_rows R]
      [--mesh [--db_axis D]] [--device cpu] [--compilation_cache_dir D]

Weights: the latest port checkpoint under ``<log_dir>/ckpt``
(``PlaceIndex.from_checkpoint``: a port training run, or ``cli/convert.py``'s
output); where there is none, the ``<log_dir>/export`` pair (how weights the
JAX package trained reach the port, as ``cli/evaluate.py`` reads them). It
raises when the directory holds neither. The model runs on the card unless
``--device cpu`` is given. ``--mesh`` shards the device DB over the visible
devices (``--db_axis`` of them, default one slice).
``--compilation_cache_dir`` (else ``$EPCNET_COMPILATION_CACHE_DIR``, else
``epcnet_torch/csrc/build``) is where the CUDA kernels are built and found
again (``utils/compile_cache.py``).

Startup runs one padded embed + query on zeros (``--warmup_points``,
default the run's ``data.num_points``) BEFORE binding the port: on the card
that is also what builds the kNN kernels with nvcc on first use
(``ops/_build.py``), so the first client request pays neither.

JSON API (``Content-Type: application/json``):

  GET  /healthz -> {"ok": true, "size": N, "dim": D}
  GET  /metrics -> {"index": {...}, "scheduler": {...}}
  POST /embed   {"points": [[[x,y,z], ...], ...]}   -> {"descriptors": [[...]]}
  POST /add     {"points": [...], "metadata": [...]} -> {"size": N}
  POST /query   {"points": [[x,y,z], ...], "k": 5}   (ONE submap, micro-batched
                with concurrent callers by the QueryScheduler)
                -> {"ids": [...], "sqdists": [...], "metadata": [...]}
  POST /query_batch {"points": [[[...]], ...], "k": 5}
                -> {"ids": [[...]], "sqdists": [[...]]}

400 for a bad body or a ``k`` outside ``[1, --k]``, 404 for an unknown
path, 500 (as JSON) for anything else. SIGTERM/SIGINT shuts the server
down: in-flight requests are joined before ``--save_on_exit`` persists the
DB, so an acknowledged ``/add`` is in the saved file.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from epcnet_torch.configs import MeshConfig
from epcnet_torch.device import resolve_device
from epcnet_torch.parallel import (
    local_devices,
    make_multislice_mesh,
    maybe_initialize_distributed,
    retrieval_db_axis,
)
from epcnet_torch.serve import PlaceIndex, QueryScheduler
from epcnet_torch.train.checkpoint import CheckpointManager
from epcnet_torch.utils.compile_cache import add_cli_arg, enable_compilation_cache
from epcnet_torch.utils.logging import log_string



def _json_handler(index: PlaceIndex, sched: QueryScheduler, default_k: int):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):  # no per-request lines on stderr
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True, "size": len(index), "dim": index.dim})
            elif self.path == "/metrics":
                self._reply(200, {"index": index.metrics(), "scheduler": sched.metrics()})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _points(self, req, ndim: int) -> np.ndarray:
            pts = np.asarray(req["points"], np.float32)
            if pts.ndim != ndim or pts.shape[-1] != 3:
                raise ValueError(
                    f"points must be rank-{ndim} with a trailing xyz axis; "
                    f"got shape {pts.shape}"
                )
            return pts

        def _k(self, req) -> int:
            k = int(req.get("k", default_k))
            if not 1 <= k <= sched.k:
                # k < 1 would mis-slice the host trim; the scheduler serves --k
                raise ValueError(f"k={k} outside [1, --k={sched.k}]; "
                                 "raise --k or request fewer neighbours")
            return k

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
            except ValueError as e:  # json.JSONDecodeError is a ValueError
                return self._reply(400, {"error": f"bad request body: {e}"})
            try:
                if self.path == "/embed":
                    pts = self._points(req, 3)
                    self._reply(200, {"descriptors": index.embed(pts).tolist()})
                elif self.path == "/add":
                    pts = self._points(req, 3)
                    index.add(pts, metadata=req.get("metadata"))
                    self._reply(200, {"size": len(index)})
                elif self.path == "/query":
                    pts = self._points(req, 2)  # [N, 3] one submap
                    k = self._k(req)
                    ids, dists = sched.submit(pts).result(timeout=60)
                    ids, dists = ids[:k], dists[:k]
                    self._reply(200, {"ids": ids.tolist(), "sqdists": dists.tolist(),
                                      "metadata": index.metadata(ids)})
                elif self.path == "/query_batch":
                    pts = self._points(req, 3)  # [B, N, 3]
                    k = self._k(req)
                    ids, dists = index.query(pts, k)
                    self._reply(200, {"ids": ids.tolist(), "sqdists": dists.tolist()})
                else:
                    self._reply(404, {"error": f"unknown path {self.path}"})
            except (KeyError, ValueError, IndexError, TypeError) as e:
                self._reply(400, {"error": repr(e)})
            except Exception as e:  # timeouts, device errors: JSON 500, not a dropped socket
                self._reply(500, {"error": repr(e)})

    return Handler


def make_server(
    index: PlaceIndex,
    host: str = "127.0.0.1",
    port: int = 8476,
    k: int = 25,
    max_wait_ms: float = 2.0,
) -> tuple[ThreadingHTTPServer, QueryScheduler]:
    """Build (server, scheduler); the caller runs ``server.serve_forever()``."""
    # the scheduler serves the index's full top-k; per-request k trims it
    sched = QueryScheduler(index, k=k, max_wait_ms=max_wait_ms)
    srv = ThreadingHTTPServer((host, port), _json_handler(index, sched, k))
    # non-daemon handler threads + block_on_close: server_close() JOINS
    # in-flight requests, so shutdown drains (an /add acknowledged to a
    # client is in the DB before --save_on_exit persists)
    srv.daemon_threads = False
    srv.block_on_close = True
    return srv, sched


def load_index(log_dir: str, **kwargs) -> PlaceIndex:
    """The index over ``log_dir``'s latest port checkpoint, else over its
    export pair; ``FileNotFoundError`` when it holds neither. ``kwargs`` go
    to ``PlaceIndex.from_checkpoint`` / ``from_export``."""
    ckpt = os.path.join(log_dir, "ckpt")
    if os.path.isdir(ckpt) and CheckpointManager(ckpt).latest_step() is not None:
        return PlaceIndex.from_checkpoint(log_dir, **kwargs)
    base = os.path.join(log_dir, "export")
    if os.path.isfile(base + ".npz") and os.path.isfile(base + ".json"):
        return PlaceIndex.from_export(base, **kwargs)
    raise FileNotFoundError(f"{log_dir}: no port checkpoint under ckpt/ and no "
                            "export pair (export.npz + export.json)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--log_dir", required=True, help="trained (or converted) run directory")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8476)
    ap.add_argument("--k", type=int, default=25)
    ap.add_argument("--max_wait_ms", type=float, default=2.0)
    ap.add_argument("--embed_batch", type=int, default=32)
    ap.add_argument("--db", default=None, help="preload a saved index .npz")
    ap.add_argument("--save_on_exit", default=None, help="persist DB on shutdown")
    ap.add_argument("--mesh", action="store_true",
                    help="shard the retrieval DB over devices")
    ap.add_argument("--db_axis", type=int, default=0,
                    help="--mesh: devices the DB shards over (0 = one slice's worth)")
    ap.add_argument("--warmup_points", type=int, default=-1,
                    help="run one embed+query on zeros at this many points per "
                    "submap BEFORE binding the port (on the card it also builds "
                    "the kernels); -1 = the run's data.num_points, 0 = skip")
    ap.add_argument("--quantize", default="none", choices=("none", "int8"),
                    help="device DB format: int8 stores descriptors quantized "
                    "per row (4x less device memory a row; host DB/save stay fp32)")
    ap.add_argument("--sync_mode", default="blocking", choices=("blocking", "background"),
                    help="when adds become query-visible: 'blocking' = "
                    "read-your-writes; 'background' = a daemon thread syncs in "
                    "chunks and queries run against the resident prefix")
    ap.add_argument("--sync_chunk_rows", type=int, default=None,
                    help="rows per device-sync chunk (default 8*block_rows)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    add_cli_arg(ap)
    args = ap.parse_args(argv)
    enable_compilation_cache(args.compilation_cache_dir)
    maybe_initialize_distributed(device=args.device)
    device = resolve_device(args.device)  # before any work: no card, no server

    mesh = None
    if args.mesh:
        # serving shards the DESCRIPTOR DB: one slice onto "db" by default
        # (a db_axis=1 mesh would never take the sharded path)
        devices = local_devices(device)
        db_axis = args.db_axis or retrieval_db_axis(devices)
        mesh = make_multislice_mesh(MeshConfig(data_axis=-1, db_axis=db_axis), devices)
        log_string(f"retrieval mesh {mesh}")
    index = load_index(args.log_dir, mesh=mesh, embed_batch=args.embed_batch,
                       quantize=args.quantize, max_k=args.k, sync_mode=args.sync_mode,
                       sync_chunk_rows=args.sync_chunk_rows, device=device)
    if args.db:
        index.load_db(args.db)
        log_string(f"loaded {len(index)} descriptors from {args.db}")

    warmup_points = args.warmup_points if args.warmup_points >= 0 else index.num_points
    if warmup_points:
        t0 = time.perf_counter()
        index.warmup(warmup_points)
        log_string(f"warmup: embed+query ran in {time.perf_counter() - t0:.1f} s "
                   f"(num_points={warmup_points}, {device})")

    srv, sched = make_server(index, args.host, args.port, args.k, args.max_wait_ms)

    def _shutdown(signum, frame):
        threading.Thread(target=srv.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)

    log_string(f"serving on http://{args.host}:{srv.server_address[1]} "
               f"(index size {len(index)})")
    try:
        srv.serve_forever()
    finally:
        srv.server_close()  # joins in-flight handler threads (drain)
        sched.stop()
        if args.save_on_exit:
            index.save(args.save_on_exit)
            log_string(f"saved {len(index)} descriptors -> {args.save_on_exit}")
        log_string("server stopped")


if __name__ == "__main__":
    main()
