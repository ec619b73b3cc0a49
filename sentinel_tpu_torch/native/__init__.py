"""Native host runtime (C++): MPMC event ring, string interner, batch
presort and the cluster frame codec.

The port's copy of ``sentinel_tpu/native``.  The compute path is PyTorch
on the card; the runtime AROUND it — request threads feeding
micro-batches, the presort of each batch, string->id interning — is
native C++ bound via ctypes (``sentinel_host.cpp``, built with ``g++`` at
first use into ``build/native/``).  The reference's numpy and Python
forms take over where no compiler is available.
"""

from sentinel_tpu_torch.native.loader import load_native, native_available
from sentinel_tpu_torch.native.ring import EventRing, NativeInterner

__all__ = ["native_available", "load_native", "EventRing", "NativeInterner"]
