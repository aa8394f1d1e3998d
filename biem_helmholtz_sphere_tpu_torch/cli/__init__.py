"""Command-line interface (reference layer 6, cli.py; argparse).

The port of biem_helmholtz_sphere_tpu.cli: the subcommands serve, jascome,
jascome-bempp, jascome-clean, accuracy, plot-accuracy and bench, with the
JAX package's flags, CSV columns and file names.  --device cpu or cuda
(default: the card, raising without CUDA) and --dtype float64 (complex128)
or float32 (complex64) pick where and in what the solves run.

    python -m biem_helmholtz_sphere_tpu_torch accuracy --device cpu ...
"""

import argparse
import logging

__all__ = ["main"]

log = logging.getLogger("biem_helmholtz_sphere_tpu_torch")


def _setup_logging(verbose):
    try:
        from rich.logging import RichHandler

        handler = RichHandler()
    except ImportError:
        handler = logging.StreamHandler()
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.WARNING,
        format="%(message)s",
        handlers=[handler],
    )


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="biem-helmholtz-sphere-tpu-torch",
        description="BIEM Helmholtz solver for hyperspheres (PyTorch/CUDA port)",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("serve", help="launch the browser GUI")
    sp.add_argument("--port", type=int, default=7860)

    jp = sub.add_parser("jascome", help="paper benchmark tables (reference cli.py:36-115)")
    jp.add_argument("--device", default=None, choices=[None, "cpu", "cuda"],
                    help="default: the card (raises without CUDA)")
    jp.add_argument("--dtype", default="float64", choices=["float64", "float32"])
    jp.add_argument("--out-dir", default="jascome")
    jp.add_argument("--n-end-max", type=int, default=9)
    jp.add_argument("--btypes", default=None, help="comma-separated subset")

    bp = sub.add_parser(
        "jascome-bempp",
        help="independent-oracle cross-check ladder (MFS; the reference's "
        "bempp-cl equivalent, cli.py:118-142)",
    )
    bp.add_argument("--out-dir", default="jascome")
    bp.add_argument(
        "--n-src-max",
        type=int,
        default=800,
        help="top of the source-count ladder (analogue of the "
        "reference's --min-h mesh ladder)",
    )

    cp = sub.add_parser("jascome-clean", help="pivot per-dimension tables")
    cp.add_argument("--out-dir", default="jascome")

    ap = sub.add_parser("accuracy", help="convergence sweeps (reference cli.py:188-271)")
    ap.add_argument("--device", default=None, choices=[None, "cpu", "cuda"],
                    help="default: the card (raises without CUDA)")
    ap.add_argument("--dtype", default="float64", choices=["float64", "float32"])
    ap.add_argument("--branching-types", default="a,ba")
    ap.add_argument(
        "--mode",
        default="k",
        choices=["k", "n_balls"],
        help="k-sweep on 2 balls or n_balls lattice sweep (both CSV "
        "families of the reference)",
    )
    ap.add_argument("--out-dir", default="accuracy")
    ap.add_argument("--k-max-log2", type=float, default=6.0)
    ap.add_argument("--n-end-max-log2", type=float, default=7.0)
    ap.add_argument(
        "--k-min-log2",
        type=float,
        default=0.0,
        help="start the k grid here (extend an existing sweep toward "
        "the extreme corner without re-running small configs)",
    )
    ap.add_argument("--n-end-min-log2", type=float, default=0.0)
    ap.add_argument("--n-balls-max-log4", type=int, default=3)
    ap.add_argument(
        "--n-balls-min-log4",
        type=int,
        default=0,
        help="start the lattice grid at (2*2^m)^2 spheres with m = this "
        "(extend an existing n_balls sweep without re-running small "
        "lattices)",
    )
    ap.add_argument(
        "--k-block",
        type=int,
        default=1,
        help="solve this many k-points per batched call (a leading batch "
        "axis; raises peak memory by the factor)",
    )
    ap.add_argument(
        "--n-end-linear",
        type=int,
        default=0,
        help="use a dense step-1 n_end grid 1..N instead of the log2 "
        "grid (the reference's accuracy_k_ba.csv sweeps n_end=1..39 "
        "densely)",
    )

    pp = sub.add_parser("plot-accuracy", help="error heatmaps from accuracy CSVs")
    pp.add_argument("--out-dir", default="accuracy")

    zp = sub.add_parser("bench", help="wall-time benchmark on one device")
    zp.add_argument("--n-end", type=int, default=16)
    zp.add_argument("--n-side", type=int, default=2)
    zp.add_argument("--k", type=float, default=4.0)
    zp.add_argument("--device", default=None, choices=[None, "cpu", "cuda"],
                    help="default: the card (raises without CUDA)")
    zp.add_argument(
        "--profile",
        default=None,
        help="write a torch.profiler trace to this directory",
    )

    args = p.parse_args(argv)
    _setup_logging(args.verbose)

    if args.cmd == "serve":
        from ..gui import serve

        serve(port=args.port)
    elif args.cmd == "jascome":
        from ._jascome import run_jascome

        run_jascome(
            args.out_dir,
            n_end_max=args.n_end_max,
            btypes=args.btypes.split(",") if args.btypes else None,
            device=args.device,
            dtype=args.dtype,
        )
    elif args.cmd == "jascome-bempp":
        # bempp-cl (the reference's dev-only oracle) is not a
        # dependency; the built-in MFS oracle is the independent method
        # here (validation/).
        from ._jascome import run_jascome_mfs

        run_jascome_mfs(args.out_dir, n_src_max=args.n_src_max)
    elif args.cmd == "jascome-clean":
        from ._jascome import clean_jascome

        clean_jascome(args.out_dir)
    elif args.cmd == "accuracy":
        from ._accuracy import run_accuracy

        run_accuracy(
            args.out_dir,
            branching_types=args.branching_types.split(","),
            mode=args.mode,
            k_max_log2=args.k_max_log2,
            n_end_max_log2=args.n_end_max_log2,
            n_balls_max_log4=args.n_balls_max_log4,
            n_balls_min_log4=args.n_balls_min_log4,
            k_block=args.k_block,
            k_min_log2=args.k_min_log2,
            n_end_min_log2=args.n_end_min_log2,
            n_end_linear=args.n_end_linear,
            device=args.device,
            dtype=args.dtype,
        )
    elif args.cmd == "plot-accuracy":
        from ._accuracy import plot_accuracy

        plot_accuracy(args.out_dir)
    elif args.cmd == "bench":
        from ._bench import run_bench

        run_bench(
            n_end=args.n_end, n_side=args.n_side, k=args.k, profile=args.profile,
            device=args.device,
        )


if __name__ == "__main__":
    main()
