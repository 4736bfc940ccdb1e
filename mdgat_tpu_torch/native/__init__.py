"""The native threaded keypoint loader (``loader.cc``, built with ``g++``
at first use) and its ctypes bindings."""

from mdgat_tpu_torch.native.loader import NativeLoader, native_available

__all__ = ["NativeLoader", "native_available"]
