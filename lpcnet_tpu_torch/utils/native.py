"""ctypes bindings of the data-preparation entries of the repository's
native library (native/liblpcnet_native.so, built from native/*.cpp): the
augmenter (dp_augment_*), the DC-blocking high-pass (dp_hp_biquad) and
the (sig_in, sig_out) pair builder (dp_build_pairs); the port of the
dp_* part of lpcnet_tpu/utils/native.py.

The shipped library is loaded first. Where it does not load (another
host's C library), it is built from native/*.cpp with the host's C++
compiler into build/lpcnet_tpu_torch/native/, never into native/.
Callers that have a numpy path use it when the library is unavailable
(data.build_pairs, cli's high-pass); data.augment raises.
"""
import ctypes
import os
import subprocess
from typing import Optional

_REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir,
                                     os.pardir))
NATIVE_DIR = os.path.join(_REPO, "native")
SHIPPED = os.path.join(NATIVE_DIR, "liblpcnet_native.so")
BUILT = os.path.join(_REPO, "build", "lpcnet_tpu_torch", "native",
                     "liblpcnet_native.so")


class NativeLib:
    """The library, loaded once per instance: lib() is the ctypes handle or
    None; how says "loaded" (the shipped file), "built" (compiled here
    into BUILT) or, on failure, why it is unavailable."""

    def __init__(self):
        self._lib = None
        self.how = None

    def lib(self) -> Optional[ctypes.CDLL]:
        if self.how is None:
            self._lib, self.how = self._open()
        return self._lib

    @staticmethod
    def _open():
        try:
            return _bind(ctypes.CDLL(SHIPPED)), "loaded"
        except OSError as e:
            shipped_err = e
        if not os.path.exists(BUILT):
            os.makedirs(os.path.dirname(BUILT), exist_ok=True)
            srcs = sorted(os.path.join(NATIVE_DIR, f)
                          for f in os.listdir(NATIVE_DIR)
                          if f.endswith(".cpp"))
            cmd = [os.environ.get("CXX", "g++"), "-O2", "-fPIC",
                   "-std=c++17", "-shared", "-o", BUILT] + srcs + ["-lm"]
            try:
                subprocess.run(cmd, check=True, capture_output=True,
                               timeout=120)
            except (OSError, subprocess.SubprocessError) as e:
                return None, (f"unavailable: {SHIPPED} does not load "
                              f"({shipped_err}) and the build failed ({e})")
        try:
            return _bind(ctypes.CDLL(BUILT)), "built"
        except OSError as e:
            return None, f"unavailable: {BUILT} does not load ({e})"


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp = ctypes.c_void_p
    lib.dp_augment_create.restype = vp
    lib.dp_augment_create.argtypes = [ctypes.c_uint64]
    lib.dp_augment_destroy.restype = None
    lib.dp_augment_destroy.argtypes = [vp]
    lib.dp_augment_frames.restype = None
    lib.dp_augment_frames.argtypes = [vp, vp, vp, ctypes.c_int]
    lib.dp_hp_biquad.restype = None
    lib.dp_hp_biquad.argtypes = [vp, vp, ctypes.c_int]
    lib.dp_build_pairs.restype = None
    lib.dp_build_pairs.argtypes = [vp, vp, vp, ctypes.c_int, vp, vp, vp]
    return lib


NATIVE = NativeLib()


def get_lib() -> Optional[ctypes.CDLL]:
    """The process's library handle, or None where it is unavailable."""
    return NATIVE.lib()
