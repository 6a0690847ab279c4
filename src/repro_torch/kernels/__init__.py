"""Hand-written Hopper kernels (csrc/), their plain PyTorch versions and the
device dispatch in ops.py."""
