"""Train a smollm-family model end to end with the port's training
substrate: the port of the JAX package's ``examples/train_smollm.py``.

Exercises the deterministic data pipeline, the train step, the WSD
schedule, async checkpointing, restart-exact resume and loss-goes-down.

    PYTHONPATH=src python -m repro_torch.examples.train_smollm --device cpu  # reduced, 200 steps
    PYTHONPATH=src python -m repro_torch.examples.train_smollm --full        # 135M, on the card
"""
import argparse
import tempfile

from repro_torch.launch import train as train_cli


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--full", action="store_true", help="full smollm-135m (slow on the CPU)")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    ckpt = tempfile.mkdtemp(prefix="smollm_ckpt_")
    argv = [
        "--arch", "smollm-135m",
        "--steps", str(args.steps),
        "--batch", "8", "--seq", "128",
        "--schedule", "wsd",  # minicpm-style warmup-stable-decay
        "--ckpt-dir", ckpt, "--ckpt-every", "50",
        "--log-every", "20",
        "--device", args.device,
    ]
    if not args.full:
        argv.append("--reduced")
    rc = train_cli.main(argv)

    # restart-exact resume from the final checkpoint (fault-tolerance check)
    print("\n-- simulating restart: resume from latest checkpoint --")
    rc |= train_cli.main(argv + ["--restore", "--steps", str(args.steps + 20)])
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
