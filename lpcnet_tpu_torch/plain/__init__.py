"""Plain PyTorch references of the port's networks: float32, TF32 off,
one operation after another, importing nothing of JAX or of the port.
The tests hold the port's fast paths against them."""
