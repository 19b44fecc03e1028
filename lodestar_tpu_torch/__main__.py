"""`python -m lodestar_tpu_torch ...`: the port's CLI (`cli.main`)."""

from lodestar_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
