"""Entry point: ``python -m repro_torch.verify <check|lint|mutants|replay>``."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
