"""FEC packet files (.fec), in numpy (the port's copy of
lpcnet_tpu/utils/fec_packets.py; reference training_tf2/fec_packets.py:
33-109 and the C reader fec_packets.c:33-123).

Layout: int16 header [version=1, header_size=14, num_packets, packet_size,
subframe_size, subframes_per_packet, num_features], then per packet an
int16 rate followed by its float32 feature subframes, time-FLIPPED.
"""
from typing import List, Optional, Tuple

import numpy as np

VERSION = 1
HEADER_SIZE = 14


def write_fec_packets(filename: str, packets: List[np.ndarray],
                      rates: Optional[List[int]] = None) -> None:
    """packets: (subframes, num_features) float arrays, oldest subframe
    first; rates: one int16 per packet (0 when None)."""
    num_packets = len(packets)
    subframes, num_features = packets[0].shape[-2:]
    subframe_size = num_features * 4
    packet_size = subframe_size * subframes + 2
    header = np.array([VERSION, HEADER_SIZE, num_packets, packet_size,
                       subframe_size, subframes, num_features], np.int16)
    with open(filename, "wb") as f:
        f.write(header.tobytes())
        for i, p in enumerate(packets):
            rate = 0 if rates is None else int(rates[i])
            f.write(np.int16(rate).tobytes())
            f.write(np.flip(np.asarray(p, np.float32), axis=-2).tobytes())


def read_fec_packets(filename: str) -> Tuple[List[np.ndarray], List[int]]:
    """The packets (oldest subframe first) and rates of a .fec file."""
    with open(filename, "rb") as f:
        header = np.frombuffer(f.read(HEADER_SIZE), dtype=np.int16)
        if header.size != 7:
            raise ValueError(f"{filename}: truncated .fec header")
        version, header_size, num_packets, packet_size, subframe_size, \
            subframes, num_features = (int(v) for v in header)
        if version != VERSION or header_size != HEADER_SIZE:
            raise ValueError(f"{filename}: not a version-{VERSION} .fec file")
        packets, rates = [], []
        for _ in range(num_packets):
            rates.append(int(np.frombuffer(f.read(2), dtype=np.int16)[0]))
            raw = np.frombuffer(f.read(subframe_size * subframes),
                                dtype=np.float32)
            packets.append(np.flip(raw.reshape(subframes, num_features),
                                   axis=-2).copy())
    return packets, rates
