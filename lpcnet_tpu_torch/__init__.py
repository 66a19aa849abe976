"""lpcnet_tpu_torch: the PyTorch/CUDA port of lpcnet_tpu for NVIDIA Hopper.

It imports torch and numpy only, never jax or lpcnet_tpu. Entry points run
on the card unless the caller passes device="cpu".
"""
