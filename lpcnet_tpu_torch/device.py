"""Device selection for the port's entry points: the card unless the caller
asks for another device. A missing card is an error, never a quiet move to
the CPU."""
import torch


def resolve_device(device=None) -> torch.device:
    """None means "cuda". Raises RuntimeError for a CUDA device on a host
    where CUDA is unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lpcnet_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
