"""Test CLI of the port (counterpart of run_test.py):

python -m ood_gan_inversion_tpu_torch.run_test --opt options/test/E4E_Face_test.yml \\
    [--force_yml k:k=v ...] [--device cuda]

Runs on the CUDA card unless `--device cpu` is given; without a card it
raises rather than test on the CPU. Results go under `results/<name>`
beside this package (or `path:results_root`).
"""

import os.path as osp

from .test import test_pipeline


def main(argv=None):
    root_path = osp.abspath(osp.join(osp.dirname(osp.abspath(__file__)), osp.pardir))
    return test_pipeline(root_path, args=argv)


if __name__ == "__main__":
    main()
