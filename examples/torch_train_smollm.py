"""End-to-end training on the port: train the reduced smollm-135m for a
few hundred steps with an auto-tuned distributed config, checkpointing,
and a mid-run injected failure (the twin of ``examples/train_smollm.py``).

    PYTHONPATH=src python examples/torch_train_smollm.py [--device cpu] [--preset full]

The arguments given are appended to the driver's (argparse takes the
last value): ``--device cpu`` trains with the plain PyTorch versions on
the host, ``--preset full`` trains smollm-135m at full width (134.5 M
parameters).  Without a card and without ``--device cpu`` it fails with
"no CUDA device".
"""

import shutil
import sys
import tempfile

from repro_torch.launch.train import main as train_main

ARGS = ["--arch", "smollm-135m", "--preset", "smoke",
        "--steps", "200", "--batch", "16", "--seq", "64",
        "--lr", "3e-3", "--tune", "--ckpt-every", "50",
        "--inject-failure", "120"]


def main(argv=None) -> None:
    extra = sys.argv[1:] if argv is None else list(argv)
    ckpt = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    try:
        train_main(ARGS + ["--ckpt-dir", ckpt] + extra)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
