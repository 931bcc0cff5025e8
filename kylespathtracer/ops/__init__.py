"""The fused frame forward and its gradient.

The XLA pipeline (render/) is the always-correct, differentiable reference.
ops/ holds the fused per-pixel frame: its component-plane math
(shade_kernel.py, frame_kernel.frame_block: vectors as separate planes,
never a trailing size-3 axis), the Pallas/Triton kernel that runs it on the
GPU, its custom VJP (frame_grad.py), and the platform table that picks the
implementation (platform.py).
"""
