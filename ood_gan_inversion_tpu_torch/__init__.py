"""PyTorch + CUDA port of `ood_gan_inversion_tpu` for one NVIDIA H100.

The JAX package beside this one is the reference: every module here keeps
its counterpart's path and names, and `tests/test_torch_*.py` hold each one
against it on the CPU. This package imports neither JAX nor the JAX package.

Layout. The public entry points (`archs.ood_e4e.OODFaceGANE4E.forward`,
`infer.InversionEngine` and the trainer `models.OODFaceGANModel`) take and
return NHWC tensors, like the JAX package.
Inside, activations are NCHW (PyTorch's convolution layout) and weights are
OIHW; the SAMM warp-blend kernel reads and writes NHWC, so `nn/samm.py`
permutes its feature around that one call, while the AlignNet body0
kernels (`ops/alignnet.py`, `ops/samm_conv.py`) read NCHW and OIHW as they
are. The phase-packed >=512px tail (`nn/stylegan2.py:Generator.packed_stage`,
off by default) works in NHWC from a stage's input to its outputs, as its
kernels do.

Devices. Entry points run on `cuda` unless the caller passes
`device="cpu"`; with no GPU and no explicit CPU request they raise
(`device.resolve_device`). The hand-written CUDA kernels launch only for
CUDA tensors; for a CPU tensor their wrappers run the plain PyTorch version,
which is what the CPU tests exercise.
"""
