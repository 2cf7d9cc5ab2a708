"""The native host runtime (``native/tfd_native.cc``) bound with ctypes."""
