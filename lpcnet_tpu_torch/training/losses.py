"""Loss-side helpers (the port of lpcnet_tpu/training/losses.py; so far the
one function the sample loop's temperature mode needs)."""
import torch


def tree_to_pdf(p: torch.Tensor) -> torch.Tensor:
    """Expand 256 sigmoid tree-node probabilities into a 256-way leaf pdf
    (training_tf2/lpcnet.py:66-94). p: (..., 256) heap-ordered node
    probabilities (index 0 unused, root at 1). Returns (..., 256): leaf c's
    probability is the product over the 8 levels, root first, of its path's
    node probability or one minus it."""
    out = None
    for b in range(8):
        nodes = p[..., (1 << b):(1 << (b + 1))]              # (..., 2^b)
        both = torch.stack([1.0 - nodes, nodes], dim=-1)     # (..., 2^b, 2)
        level = both.reshape(p.shape[:-1] + (2 << b,)).repeat_interleave(
            256 // (2 << b), dim=-1)
        out = level if out is None else out * level
    return out
