"""Host utilities, the port of the JAX package's ``utils/``: ``native``, the
ctypes bindings of the port's own C++ host engines (``csrc/host/``); and the
port's own ``tracing``, its one counter registry and its spans.
"""
