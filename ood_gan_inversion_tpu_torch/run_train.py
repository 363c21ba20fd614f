"""Training CLI of the port (counterpart of run_train.py):

python -m ood_gan_inversion_tpu_torch.run_train --opt options/train/E4E_Face.yml \\
    [--auto_resume] [--debug] [--seed N] [--force_yml k:k=v ...] [--device cuda]

Runs on the CUDA card unless `--device cpu` is given; without a card it
raises rather than train on the CPU. Experiments go under
`experiments/<name>` beside this package (or `path:experiments_root`).
"""

import os.path as osp

from .train import train_pipeline


def main(argv=None):
    root_path = osp.abspath(osp.join(osp.dirname(osp.abspath(__file__)), osp.pardir))
    train_pipeline(root_path, args=argv)


if __name__ == "__main__":
    main()
