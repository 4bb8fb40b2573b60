"""Run a JAX-package entry point or tool as it is, with its fixed paths
under /tmp moved:

    python scripts/jax_run.py <dir> -m tcnerf.train.train_delta_ngf [args]
    python scripts/jax_run.py <dir> --data-dir <D> [--override=<k=v> ...] \\
        tools/strong_goal_validation.py [args]

The trainer's pid file (`/tmp/tcnerf_trainer.pid`) goes to <dir>. With
`--data-dir`, every `load_config` of the JAX package takes `data_dir=<D>`
and `ws_dir=<D>` after its own overrides (so the strong tool's fixed
`/tmp/convcpu` gives way), then each `--override`. No file of the JAX
package is changed; the JAX package runs on the CPU
(`JAX_PLATFORMS=cpu`)."""
import builtins
import os
import runpy
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    pid_dir, args = argv[0], argv[1:]
    late = []
    while args and args[0].startswith("--"):
        if args[0] == "--data-dir":
            late += [f"data_dir={args[1]}", f"ws_dir={args[1]}"]
            args = args[2:]
        elif args[0].startswith("--override="):
            late.append(args[0].split("=", 1)[1])
            args = args[1:]
        else:
            raise SystemExit(f"unknown option {args[0]}")
    _open = builtins.open

    def moved(path, *a, **kw):
        if path == "/tmp/tcnerf_trainer.pid":
            path = os.path.join(pid_dir, "tcnerf_trainer.pid")
        return _open(path, *a, **kw)

    builtins.open = moved
    sys.path.insert(0, REPO)
    if late:
        from tcnerf.train import config
        load = config.load_config
        config.load_config = lambda root, name, overrides=(): load(
            root, name, [*overrides, *late])
    if args[0] == "-m":
        sys.argv = [args[1], *args[2:]]
        runpy.run_module(args[1], run_name="__main__", alter_sys=True)
    else:
        sys.argv = list(args)
        runpy.run_path(args[0], run_name="__main__")


if __name__ == "__main__":
    main(sys.argv[1:])
