"""Deployment example on the PyTorch port (``tpugan_torch``): export a
generator, serve it, query it.

Run (after training any preset — see examples_torch/train_dcgan_mnist.py):

    python examples_torch/serve_and_query.py --ckpt runs/dcgan_mnist/ckpt
        [--device cuda]

What it shows: the one-file export artifact (a ``torch.export`` program
and its metadata, ``tpugan_torch/export``), the micro-batching HTTP
server, and that served pixels equal local pixels for the same seed (the
determinism contract survives the network hop).
"""

import argparse
import http.client
import io
import json
import os
import sys
import threading

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: raises without a card) or cpu")
    args = ap.parse_args()

    from tpugan_torch.cli import _load_generator_from_ckpt
    from tpugan_torch.export import export_generator, load_generator
    from tpugan_torch.serve.server import BatchingEngine, make_server
    from tpugan_torch.utils.device import resolve_device

    resolve_device(args.device)
    cfg, g, step = _load_generator_from_ckpt(args.ckpt, args.device)
    gen = load_generator(export_generator(cfg, g), device=args.device)
    print(f"exported step-{step} generator "
          f"({gen.image_size}px, nz={gen.nz})")

    engine = BatchingEngine(gen, max_batch=32)
    srv = make_server(engine, port=0)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    print(f"serving on 127.0.0.1:{port}")

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/sample",
                 json.dumps({"n": 4, "seed": 7, "format": "npy"}),
                 {"Content-Type": "application/json"})
    served = np.load(io.BytesIO(conn.getresponse().read()))
    conn.close()

    local = gen.sample(4, seed=7)
    print("served == local for seed 7:",
          bool(np.allclose(served, local, rtol=1e-4, atol=1e-8)))

    srv.shutdown()
    srv.server_close()
    engine.close()


if __name__ == "__main__":
    main()
