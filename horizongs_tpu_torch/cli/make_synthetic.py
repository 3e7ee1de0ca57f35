"""`python -m horizongs_tpu_torch.cli.make_synthetic PATH`: write the
synthetic Blender-format dataset the synthetic configs train on
(`configs/synthetic/quickstart.yaml`, `flagship512.yaml`), rendered from a
known gaussian cloud by the dense oracle on the card (`--device cpu` for
the CPU), so no download is needed."""
from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Write a synthetic Blender-format dataset")
    parser.add_argument("path")
    parser.add_argument("--n_train", type=int, default=12)
    parser.add_argument("--n_test", type=int, default=4)
    parser.add_argument("--width", type=int, default=96)
    parser.add_argument("--height", type=int, default=96)
    parser.add_argument("--n_gauss", type=int, default=60)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None,
                        help="where the frames are rendered: the card "
                        "when omitted (raises without one), or cpu")
    args = parser.parse_args(argv)

    from horizongs_tpu_torch.data.synthetic import (
        write_synthetic_blender_dataset)
    write_synthetic_blender_dataset(
        args.path, n_train=args.n_train, n_test=args.n_test,
        width=args.width, height=args.height, n_gauss=args.n_gauss,
        seed=args.seed, device=args.device)
    print(f"synthetic dataset written to {args.path} "
          f"({args.n_train} train / {args.n_test} test views, "
          f"{args.width}x{args.height})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
