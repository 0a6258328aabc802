"""`python -m fast_dit_torch.train`: the trainer CLI (see `cli.py`)."""

from .cli import main, parse_args

if __name__ == "__main__":
    main(parse_args())
