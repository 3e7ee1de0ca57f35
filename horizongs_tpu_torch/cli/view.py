"""`python -m horizongs_tpu_torch.cli.view -m PATH`: the remote viewer
server on the card (`--device cpu` for the CPU).

The JAX package's `cli/view.py`: serves a trained model over the SIBR
network-GUI TCP protocol (`viewer/server.py`; the reference's
`gaussian_renderer/network_gui.py`). Connect with a SIBR remote client or
any client speaking the same framing.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description="Viewer server")
    parser.add_argument("-m", "--model_path", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--rasterizer", default="cuda",
                        choices=["cuda", "dense"])
    parser.add_argument("--device", default=None,
                        help="the card when omitted (raises without one), "
                        "or cpu")
    parser.add_argument("--max_requests", type=int, default=None)
    args = parser.parse_args(argv)

    from horizongs_tpu_torch.device import resolve_device
    from horizongs_tpu_torch.viewer.server import serve_model
    device = resolve_device(args.device)
    print(f"viewer listening on {args.host}:{args.port}")
    serve_model(args.model_path, host=args.host, port=args.port,
                rasterizer=args.rasterizer, load_iteration=args.iteration,
                max_requests=args.max_requests, device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
