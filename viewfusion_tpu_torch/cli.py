"""Command-line entry point of the port, with the JAX CLI's flags:
-c/--config, -s/--src, -g/--gpu (accepted), -t/--train, -e/--eval,
-r/--resume, --wandb, -i/--inference, -ar/--autoregressive,
-gif/--generate_gifs, -ex/--extrapolate, and --device (``cuda`` unless
``cpu`` is asked for).

    python -m viewfusion_tpu_torch.cli -c configs/small-tpu-1.yaml -t
    python -m viewfusion_tpu_torch.cli -s logs/<run> -e
    python -m viewfusion_tpu_torch.cli -s logs/<run> -i -ex -ar -gif

``kill -USR1 <pid>`` prints every thread's Python stack to stderr
without stopping the run.
"""

from __future__ import annotations

import argparse
import io

from viewfusion_tpu_torch.training.trainer import Experiment

__all__ = ["get_arg_parser", "main"]


def get_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m viewfusion_tpu_torch.cli")
    parser.add_argument("-c", "--config", type=str, help="YAML config file")
    parser.add_argument("-s", "--src", type=str, default=None,
                        help="run directory (-e, -r, -i)")
    parser.add_argument("-g", "--gpu", action="store_true", default=False,
                        help="accepted for the reference CLI; see --device")
    parser.add_argument("-t", "--train", action="store_true", default=False)
    parser.add_argument("-e", "--eval", action="store_true", default=False)
    parser.add_argument("-r", "--resume", action="store_true", default=False)
    parser.add_argument("--wandb", action="store_true",
                        help="Log run to Weights and Biases.")
    parser.add_argument("-i", "--inference", action="store_true",
                        default=False)
    parser.add_argument("-ar", "--autoregressive", action="store_true",
                        default=False)
    parser.add_argument("-gif", "--generate_gifs", action="store_true",
                        default=False)
    parser.add_argument("-ex", "--extrapolate", action="store_true",
                        default=False)
    parser.add_argument("--device", default="cuda",
                        help='"cuda" (default) or "cpu"')
    return parser


def _enable_hang_diagnostics() -> None:
    """SIGUSR1 dumps every thread's Python stack to stderr."""
    import faulthandler
    import signal

    try:
        # chain=False: chaining to SIG_DFL would end the run after the dump
        faulthandler.register(signal.SIGUSR1, all_threads=True, chain=False)
    except (AttributeError, ValueError, io.UnsupportedOperation):
        pass  # not the main thread, no SIGUSR1, or no real stderr


def main(argv=None) -> Experiment:
    """Parse ``argv`` (``sys.argv[1:]`` if None), run the asked modes and
    return the :class:`Experiment`."""
    args = get_arg_parser().parse_args(argv)
    _enable_hang_diagnostics()
    experiment = Experiment(args)
    if args.train:
        experiment.train()
    if args.eval:
        experiment.eval()
    if args.inference:
        experiment.inference()
    return experiment


if __name__ == "__main__":
    main()
