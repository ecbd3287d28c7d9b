"""Compute RAM ISA, instruction-sequence generators and the bit-plane
execution engine on PyTorch tensors."""
