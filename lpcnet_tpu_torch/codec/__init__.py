"""The 1.6 kb/s codec (the port of lpcnet_tpu/codec): bit packing
(packet.py), vector quantizers (vq.py), superframe encode and decode
(codec.py)."""
