"""KISS99 RNG (reference src/kiss99.c:32-81), stream for stream identical to
lpcnet_tpu/ops/kiss99.py.

Seeding is host-side numpy. The batched step works on tensors: a state is a
(..., 4) int64 tensor [z, w, jsr, jcong] holding the uint32 values of the
JAX package's (..., 4) uint32 state. PyTorch has little uint32 arithmetic,
so each step computes in int64 and masks every result to 32 bits.
"""
import numpy as np
import torch

_U16 = np.uint32(0xFFFF)
_M32 = 0xFFFFFFFF


def seed_from_bytes(data: bytes) -> np.ndarray:
    """Host-side seeding, mirrors kiss99_srand (src/kiss99.c:32-57)."""
    z = np.uint32(362436069)
    w = np.uint32(521288629)
    jsr = np.uint32(123456789)
    jcong = np.uint32(380116160)
    n = len(data)
    i = 3
    while i < n:
        z = np.uint32(z ^ data[i - 3])
        w = np.uint32(w ^ data[i - 2])
        jsr = np.uint32(jsr ^ data[i - 1])
        jcong = np.uint32(jcong ^ data[i])
        state = np.array([z, w, jsr, jcong], dtype=np.uint32)
        state, _ = _next_np(state)
        z, w, jsr, jcong = state
        i += 4
    if i - 3 < n:
        z = np.uint32(z ^ data[i - 3])
    if i - 2 < n:
        w = np.uint32(w ^ data[i - 2])
    if i - 1 < n:
        jsr = np.uint32(jsr ^ data[i - 1])
    # short-cycle fixes (kiss99.c:54-56)
    if z == 0 or z == np.uint32(0x9068FFFF):
        z = np.uint32(z + 1)
    if w == 0 or w == np.uint32(0x464FFFFF):
        w = np.uint32(w + 1)
    if jsr == 0:
        jsr = np.uint32(jsr + 1)
    return np.array([z, w, jsr, jcong], dtype=np.uint32)


def default_seed() -> np.ndarray:
    """The reference seeds synthesis with the string "LPCNet" (lpcnet.c:176)."""
    return seed_from_bytes(b"LPCNet")


def _step(z, w, jsr, jcong):
    znew = np.uint32(36969) * (z & _U16) + (z >> 16)
    wnew = np.uint32(18000) * (w & _U16) + (w >> 16)
    mwc = (znew << 16) + wnew
    shr3 = jsr ^ (jsr << 13)
    shr3 = shr3 ^ (shr3 >> 17)
    shr3 = shr3 ^ (shr3 << 5)
    cong = np.uint32(69069) * jcong + np.uint32(1234567)
    out = (mwc ^ cong) + shr3
    return znew, wnew, shr3, cong, out


def _next_np(state: np.ndarray):
    with np.errstate(over="ignore"):
        z, w, jsr, cong, out = _step(*(np.uint32(v) for v in state))
    return np.array([z, w, jsr, cong], dtype=np.uint32), out


def batched_seed(batch: int, base: bytes = b"LPCNet",
                 per_stream: bool = False) -> np.ndarray:
    """(batch, 4) uint32 seeds. per_stream=False replicates the reference seed
    on every stream; per_stream=True decorrelates streams by appending the
    stream index."""
    if not per_stream:
        return np.tile(default_seed(), (batch, 1))
    return np.stack([seed_from_bytes(base + i.to_bytes(4, "little"))
                     for i in range(batch)])


def to_tensor(state: np.ndarray, device=None) -> torch.Tensor:
    """uint32 numpy state -> the int64 tensor form used by kiss99_next."""
    return torch.as_tensor(np.asarray(state, np.uint32).astype(np.int64),
                           device=device)


def kiss99_next(state: torch.Tensor):
    """One RNG step (src/kiss99.c:59-81). state: (..., 4) int64 holding
    uint32 values. Returns (new_state, draw of shape state.shape[:-1],
    int64 holding a uint32)."""
    z, w, jsr, jcong = state.unbind(-1)
    znew = 36969 * (z & 0xFFFF) + (z >> 16)
    wnew = 18000 * (w & 0xFFFF) + (w >> 16)
    mwc = ((znew << 16) + wnew) & _M32
    shr3 = jsr ^ ((jsr << 13) & _M32)
    shr3 = shr3 ^ (shr3 >> 17)
    shr3 = shr3 ^ ((shr3 << 5) & _M32)
    cong = (69069 * jcong + 1234567) & _M32
    out = ((mwc ^ cong) + shr3) & _M32
    return torch.stack([znew, wnew, shr3, cong], dim=-1), out
